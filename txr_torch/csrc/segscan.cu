// Per-segment inclusive prefix sums of up to eight f32 columns, for Hopper.
//
// Replaces the TPU kernel txr/ops/scan.py:_segscan_kernel: for every column
// c and row i, out[c][i] = the sum of col[c] from the last row at or before
// i whose start flag is set (or from row 0) up to i, so the value at a
// segment's last row is that segment's total.
//
// Bound on this card: bytes.  The function reads 4*D + 1 bytes and writes
// 4*D bytes per row and does one add per value, so device-memory bandwidth
// is the limit.
//
// Design: the TPU kernel walks its blocks in order and hands a carry from
// one to the next; here blocks run in no order, so the scan is three
// launches.  (1) Every block of 256 threads scans a tile of 2048 rows on
// its own: each thread scans eight consecutive rows in registers, a
// warp-shuffle scan joins the threads, and the block writes its local
// result together with one aggregate per block: the sum since the last
// start in the tile, whether the tile holds a start at all, and the
// position of its first start.  (2) One block scans the few thousand
// aggregates into the carry that enters each tile.  (3) A last pass adds
// that carry to the rows in front of each tile's first start, which with
// short segments is a handful of rows per tile.  The extra traffic of (2)
// and (3) is small beside the single read and write of (1).  Every sum is
// taken in a fixed order and no float atomics are used, so the result is
// the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_COLS = 8;
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int CARRY_THREADS = 1024;

struct Cols {
  const float* p[MAX_COLS];
};

struct VF {
  float v;  // sum since the last start (or since the beginning)
  int f;    // a start was seen
};

__device__ __forceinline__ VF combine(const VF& a, const VF& b) {
  VF r;
  r.v = b.f ? b.v : a.v + b.v;
  r.f = a.f | b.f;
  return r;
}

// Exclusive segmented scan of one (v, f) pair per thread across the block.
// `warp_aggs` is shared scratch for 32 entries.
__device__ __forceinline__ VF block_exclusive_scan(VF x, VF* warp_aggs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  VF inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    VF up;
    up.v = __shfl_up_sync(0xffffffffu, inc.v, o);
    up.f = __shfl_up_sync(0xffffffffu, inc.f, o);
    if (lane >= o) inc = combine(up, inc);
  }
  if (lane == 31) warp_aggs[warp] = inc;
  __syncthreads();
  VF prefix;
  prefix.v = 0.f;
  prefix.f = 0;
  for (int w = 0; w < warp; ++w) prefix = combine(prefix, warp_aggs[w]);
  VF ex;
  ex.v = __shfl_up_sync(0xffffffffu, inc.v, 1);
  ex.f = __shfl_up_sync(0xffffffffu, inc.f, 1);
  if (lane == 0) {
    ex.v = 0.f;
    ex.f = 0;
  }
  __syncthreads();  // warp_aggs may be reused by the caller's next column
  return combine(prefix, ex);
}

__global__ void __launch_bounds__(THREADS)
segscan_local_kernel(Cols cols, const uint8_t* __restrict__ starts,
                     float* __restrict__ out, int64_t n, int ncols,
                     float* __restrict__ agg_val, int* __restrict__ agg_flag,
                     int* __restrict__ first_start) {
  __shared__ VF warp_aggs[32];
  __shared__ int s_first;
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE +
                       static_cast<int64_t>(tid) * ITEMS;
  if (tid == 0) s_first = TILE;
  __syncthreads();

  unsigned fmask = 0u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t idx = base + i;
    if (idx < n && starts[idx]) fmask |= 1u << i;
  }
  // rows of this thread in front of its first start take the incoming sum
  const int nfront = fmask ? __ffs(fmask) - 1 : ITEMS;
  if (fmask) atomicMin(&s_first, tid * ITEMS + nfront);

  for (int c = 0; c < ncols; ++c) {
    const float* __restrict__ src = cols.p[c];
    float v[ITEMS];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t idx = base + i;
      const float x = idx < n ? src[idx] : 0.f;
      run = ((fmask >> i) & 1u) ? x : run + x;
      v[i] = run;
    }
    VF mine;
    mine.v = run;
    mine.f = fmask ? 1 : 0;
    const VF prefix = block_exclusive_scan(mine, warp_aggs);
    float* __restrict__ dst = out + static_cast<int64_t>(c) * n;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t idx = base + i;
      if (idx < n) dst[idx] = i < nfront ? v[i] + prefix.v : v[i];
    }
    if (tid == THREADS - 1) {
      const VF total = combine(prefix, mine);
      agg_val[static_cast<int64_t>(blockIdx.x) * MAX_COLS + c] = total.v;
      if (c == 0) agg_flag[blockIdx.x] = total.f;
    }
  }
  __syncthreads();
  if (tid == 0) first_start[blockIdx.x] = s_first;
}

// carry[t][c] = the sum that enters tile t: the exclusive segmented scan of
// the tile aggregates.  One block; each thread owns a run of tiles.
__global__ void __launch_bounds__(CARRY_THREADS)
segscan_carry_kernel(const float* __restrict__ agg_val,
                     const int* __restrict__ agg_flag,
                     float* __restrict__ carry, int ntiles, int ncols) {
  __shared__ VF warp_aggs[32];
  const int per = (ntiles + CARRY_THREADS - 1) / CARRY_THREADS;
  const int lo = min(static_cast<int>(threadIdx.x) * per, ntiles);
  const int hi = min(lo + per, ntiles);
  for (int c = 0; c < ncols; ++c) {
    VF mine;
    mine.v = 0.f;
    mine.f = 0;
    for (int t = lo; t < hi; ++t) {
      VF a;
      a.v = agg_val[static_cast<int64_t>(t) * MAX_COLS + c];
      a.f = agg_flag[t];
      mine = combine(mine, a);
    }
    VF run = block_exclusive_scan(mine, warp_aggs);
    for (int t = lo; t < hi; ++t) {
      carry[static_cast<int64_t>(t) * MAX_COLS + c] = run.v;
      VF a;
      a.v = agg_val[static_cast<int64_t>(t) * MAX_COLS + c];
      a.f = agg_flag[t];
      run = combine(run, a);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
segscan_apply_kernel(float* __restrict__ out, const float* __restrict__ carry,
                     const int* __restrict__ first_start, int64_t n,
                     int ncols) {
  const int tile = blockIdx.x + 1;  // tile 0 has no incoming sum
  const int front = first_start[tile];
  const int64_t base = static_cast<int64_t>(tile) * TILE;
  for (int i = threadIdx.x; i < front; i += THREADS) {
    const int64_t idx = base + i;
    if (idx >= n) break;
    for (int c = 0; c < ncols; ++c) {
      out[static_cast<int64_t>(c) * n + idx] +=
          carry[static_cast<int64_t>(tile) * MAX_COLS + c];
    }
  }
}

}  // namespace

// Tiles of the first launch for n rows (the wrapper sizes the scratch).
extern "C" int txr_segscan_tile() { return TILE; }

// cols: host array of `ncols` device pointers to (n,) f32; starts: (n,) u8;
// out: (ncols, n) f32; fscratch: 2*ntiles*8 f32; iscratch: 2*ntiles i32,
// with ntiles = ceil(n / tile).  Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int txr_segscan_fwd(const void* const* cols, const void* starts,
                               void* out, long long n, int ncols,
                               void* fscratch, void* iscratch, void* stream) {
  if (ncols < 1 || ncols > MAX_COLS || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  for (int i = 0; i < MAX_COLS; ++i)
    c.p[i] = static_cast<const float*>(cols[i < ncols ? i : 0]);
  const int ntiles = static_cast<int>((n + TILE - 1) / TILE);
  float* agg_val = static_cast<float*>(fscratch);
  float* carry = agg_val + static_cast<int64_t>(ntiles) * MAX_COLS;
  int* agg_flag = static_cast<int*>(iscratch);
  int* first_start = agg_flag + ntiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  segscan_local_kernel<<<ntiles, THREADS, 0, s>>>(
      c, static_cast<const uint8_t*>(starts), static_cast<float*>(out), n,
      ncols, agg_val, agg_flag, first_start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ntiles > 1) {
    segscan_carry_kernel<<<1, CARRY_THREADS, 0, s>>>(agg_val, agg_flag, carry,
                                                     ntiles, ncols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    segscan_apply_kernel<<<ntiles - 1, THREADS, 0, s>>>(
        static_cast<float*>(out), carry, first_start, n, ncols);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
