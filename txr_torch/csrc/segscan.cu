// Per-segment inclusive prefix sums in one pass, for Hopper, and the voxel
// map's segment reduce built around the same scan.
//
// Replaces the TPU kernel txr/ops/scan.py:_segscan_kernel: for every column
// c and row i, out[c][i] = the sum of col[c] from the last row at or before
// i whose start flag is set (or from row 0) up to i, so the value at a
// segment's last row is that segment's total.  The second entry point,
// txr_offset_reduce_fwd, runs the same scan inside the packed voxel map's
// insert (txr_torch/fusion/offset_map.py:_reduce_packed, counterpart of
// txr/fusion/offset_map.py:163-232): it builds the seven weighted columns
// and the segment flags from the key-sorted rows itself, and at each
// segment end writes the voxel's four packed columns at the segment's rank.
//
// Bound on this card: bytes.  The scan reads 4*D + 1 bytes and writes 4*D
// bytes per row and does one add per value; the reduce reads 24 bytes per
// row (key, permutation index, two gathered payload words) and writes 16
// bytes per kept voxel.
//
// Design: one launch that reads every row once and writes every row once.
//   * Tiles of 2048 rows (256 threads, eight consecutive rows each).  A
//     block takes its tile's index from an atomic counter, so every tile in
//     front of it has started: waiting on a predecessor cannot deadlock.
//   * Inside a tile: each thread scans its eight rows in registers, a warp
//     shuffle scan joins the threads of a warp, and the eight warp totals
//     are folded in order through shared memory.
//   * Across tiles, decoupled look-back: a tile publishes its aggregate (the
//     sum since its last start, and whether it holds a start) as soon as it
//     is known, looks back over its predecessors one warp-wide window of 32
//     tiles at a time until it meets an inclusive prefix, or an aggregate
//     that holds a start (which no earlier row can change), then publishes
//     its own inclusive prefix.  The reduce also carries the number of
//     segment starts, which a start does not reset, so its look-back stops
//     only at an inclusive prefix.
//   * Results repeat bit for bit.  The value entering tile t is folded left
//     to right: from the tile where the look-back stopped, each later
//     aggregate is added in order.  Every inclusive prefix is therefore the
//     left fold of all aggregates before it, whichever predecessor a tile
//     happened to find ready, and the two entry points, which share this
//     code, give the same sums on the same rows.  No float atomics.
//   * The standalone scan moves each column of a tile through shared memory,
//     so that it reads and writes device memory in whole lines: eight
//     consecutive rows a thread, stored straight from registers, would be
//     eight partial writes of every 32-byte sector.
//   * Rows past N do not exist for the scan (zero values, no start); the
//     status words and the tile counter are zeroed before each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_COLS = 8;
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int REDUCE_COLS = 7;  // x, y, z offsets, r, g, b (weighted), w

constexpr int ST_AGG = 1;    // the tile's aggregate is published
constexpr int ST_INC = 2;    // its inclusive prefix is published
constexpr int ST_START = 4;  // its aggregate holds a segment start

constexpr int INT32_MAX_ = 2147483647;
constexpr uint32_t W_MAX = 2047;  // 11-bit weight saturation

// Look-back state, sized by the host (txr_torch/ops/scan.py:scan_geometry):
// ints [counter, status[T], agg_cnt[T], inc_cnt[T]], floats [agg[T][8],
// inc[T][8]]; the counter and the status words are zeroed per launch.
struct Scratch {
  int* counter;
  int* status;
  int* agg_cnt;
  int* inc_cnt;
  float* agg;
  float* inc;
};

Scratch carve(void* iscratch, void* fscratch, int tiles) {
  Scratch s;
  s.counter = static_cast<int*>(iscratch);
  s.status = s.counter + 1;
  s.agg_cnt = s.status + tiles;
  s.inc_cnt = s.agg_cnt + tiles;
  s.agg = static_cast<float*>(fscratch);
  s.inc = s.agg + static_cast<int64_t>(tiles) * MAX_COLS;
  return s;
}

// A segmented running sum of NC columns over a range of rows.
template <int NC>
struct Run {
  float v[NC];  // sum since the last start in the range (or since its top)
  int f;        // the range holds a start
  int cnt;      // starts in the range
};

template <int NC>
__device__ __forceinline__ Run<NC> identity() {
  Run<NC> r;
#pragma unroll
  for (int c = 0; c < NC; ++c) r.v[c] = 0.f;
  r.f = 0;
  r.cnt = 0;
  return r;
}

template <int NC>
__device__ __forceinline__ Run<NC> combine(const Run<NC>& a,
                                           const Run<NC>& b) {
  Run<NC> r;
#pragma unroll
  for (int c = 0; c < NC; ++c) r.v[c] = b.f ? b.v[c] : a.v[c] + b.v[c];
  r.f = a.f | b.f;
  r.cnt = a.cnt + b.cnt;
  return r;
}

template <int NC>
struct BlockShared {
  Run<NC> warp_total[WARPS];
  Run<NC> total;  // the tile's aggregate
  Run<NC> carry;  // what enters the tile
  int tile;
};

__device__ __forceinline__ int load_status(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_status(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

template <int NC>
__device__ __forceinline__ int next_tile(const Scratch& sc,
                                         BlockShared<NC>& sh) {
  if (threadIdx.x == 0) sh.tile = atomicAdd(sc.counter, 1);
  __syncthreads();
  return sh.tile;
}

// Exclusive scan of one Run per thread, in thread order.  Thread 0 also
// leaves the block total in sh.total.
template <int NC>
__device__ __forceinline__ Run<NC> block_exclusive(const Run<NC>& x,
                                                   BlockShared<NC>& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Run<NC> inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Run<NC> up;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      up.v[c] = __shfl_up_sync(0xffffffffu, inc.v[c], o);
    up.f = __shfl_up_sync(0xffffffffu, inc.f, o);
    up.cnt = __shfl_up_sync(0xffffffffu, inc.cnt, o);
    if (lane >= o) inc = combine(up, inc);
  }
  if (lane == 31) sh.warp_total[warp] = inc;
  Run<NC> ex;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    ex.v[c] = __shfl_up_sync(0xffffffffu, inc.v[c], 1);
  ex.f = __shfl_up_sync(0xffffffffu, inc.f, 1);
  ex.cnt = __shfl_up_sync(0xffffffffu, inc.cnt, 1);
  if (lane == 0) ex = identity<NC>();
  __syncthreads();
  Run<NC> prefix = identity<NC>();
  for (int w = 0; w < warp; ++w) prefix = combine(prefix, sh.warp_total[w]);
  if (threadIdx.x == 0) {
    Run<NC> t = identity<NC>();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t = combine(t, sh.warp_total[w]);
    sh.total = t;
  }
  return combine(prefix, ex);
}

// Thread 0 makes a tile's aggregate (ST_AGG) or inclusive prefix (ST_INC)
// visible: the values first, then, after a fence, the status word.
template <int NC>
__device__ __forceinline__ void publish(const Scratch& sc, int tile,
                                        const Run<NC>& r, int state,
                                        int start) {
  float* dst = (state == ST_INC ? sc.inc : sc.agg) +
               static_cast<int64_t>(tile) * MAX_COLS;
#pragma unroll
  for (int c = 0; c < NC; ++c) __stcg(dst + c, r.v[c]);
  __stcg((state == ST_INC ? sc.inc_cnt : sc.agg_cnt) + tile, r.cnt);
  __threadfence();
  store_status(sc.status + tile, state | (start ? ST_START : 0));
}

// Warp 0 of tile t > 0: what enters the tile, into sh.carry (values, and
// with COUNT the number of starts in front of the tile).
template <int NC, bool COUNT>
__device__ __forceinline__ void look_back(const Scratch& sc, int tile,
                                          BlockShared<NC>& sh) {
  const int lane = threadIdx.x & 31;
  int hi = tile - 1;  // lane l looks at tile hi - l
  int stop = 0, stop_inc = 0, nearest_start = -1;
  for (;;) {
    const int k = hi - lane;
    const int st = k >= 0 ? load_status(sc.status + k) : ST_INC;
    const bool inc = (st & ST_INC) != 0;
    const bool start = (st & ST_START) != 0;
    const unsigned stops =
        __ballot_sync(0xffffffffu, inc || (!COUNT && start));
    const unsigned ready = __ballot_sync(0xffffffffu, st != 0);
    const int first = stops ? __ffs(stops) - 1 : 32;
    const unsigned need = first == 32 ? 0xffffffffu : (1u << first) - 1u;
    // a tile in front of the stop has not published yet: read again
    if ((ready & need) != need) continue;
    if (COUNT && nearest_start < 0) {
      const unsigned s = __ballot_sync(0xffffffffu, start) & need;
      if (s) nearest_start = hi - (__ffs(s) - 1);
    }
    if (first < 32) {
      stop = hi - first;
      stop_inc = __shfl_sync(0xffffffffu, inc ? 1 : 0, first);
      break;
    }
    hi -= 32;
  }
  __threadfence();
  // Values: from the nearest tile that fixes them (an inclusive prefix or
  // an aggregate with a start), then every aggregate after it, in order.
  const int from = COUNT && nearest_start >= 0 ? nearest_start : stop;
  if (lane < NC) {
    const float* src = (from == stop && stop_inc ? sc.inc : sc.agg) +
                       static_cast<int64_t>(from) * MAX_COLS;
    float v = __ldcg(src + lane);
    for (int k = from + 1; k < tile; ++k)
      v += __ldcg(sc.agg + static_cast<int64_t>(k) * MAX_COLS + lane);
    sh.carry.v[lane] = v;
  }
  if (COUNT) {  // integer counts: any order gives the same sum
    int c = 0;
    for (int k = stop + 1 + lane; k < tile; k += 32)
      c += __ldcg(sc.agg_cnt + k);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (lane == 0) sh.carry.cnt = c + __ldcg(sc.inc_cnt + stop);
  } else if (lane == 0) {
    sh.carry.cnt = 0;
  }
  if (lane == 0) sh.carry.f = 0;  // no reader uses it
  __syncwarp();
}

// Thread order within the tile, then the tiles in front: what enters this
// thread's first row, given the thread's own aggregate `mine` (the segmented
// sum of its eight rows, taken row by row from zero, whether they hold a
// start, and how many).  A row before the thread's first start adds the
// result's values to its own running sum; the result's count is the number
// of starts in front of the thread (COUNT).
template <int NC, bool COUNT>
__device__ __forceinline__ Run<NC> carry_in(const Run<NC>& mine, int tile,
                                            const Scratch& sc,
                                            BlockShared<NC>& sh) {
  const Run<NC> prefix = block_exclusive(mine, sh);
  if (threadIdx.x < 32) {
    if (tile == 0) {
      if (threadIdx.x == 0) {
        publish(sc, 0, sh.total, ST_INC, sh.total.f);
        sh.carry = identity<NC>();
      }
    } else {
      if (threadIdx.x == 0) publish(sc, tile, sh.total, ST_AGG, sh.total.f);
      look_back<NC, COUNT>(sc, tile, sh);
      if (threadIdx.x == 0)
        publish(sc, tile, combine(sh.carry, sh.total), ST_INC, sh.total.f);
    }
  }
  __syncthreads();
  return combine(sh.carry, prefix);
}

struct Cols {
  const float* p[MAX_COLS];
};

// Two blocks of 256 threads a multiprocessor (at most 128 registers), so
// that one block's loads overlap the other's look-back; eight columns need
// more and run one block a multiprocessor.
template <int NC>
__global__ void __launch_bounds__(THREADS, NC < MAX_COLS ? 2 : 1)
segscan_kernel(Cols cols, const uint8_t* __restrict__ starts,
               float* __restrict__ out, int64_t n, Scratch sc) {
  __shared__ BlockShared<NC> sh;
  // One column of the tile at a time passes through here, so that device
  // memory is read and written in whole lines (warp w of pass j touches
  // rows j * 256 + 32 w .. + 31) while each thread scans eight consecutive
  // rows.
  __shared__ __align__(16) float stage[TILE];
  const int tile = next_tile(sc, sh);
  const int64_t tile0 = static_cast<int64_t>(tile) * TILE;
  const int64_t base = tile0 + static_cast<int64_t>(threadIdx.x) * ITEMS;
  unsigned fmask = 0u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t idx = base + i;
    if (idx < n && starts[idx]) fmask |= 1u << i;
  }
  float x[ITEMS][NC];
  {
    float y[NC][ITEMS];  // all loads in flight before the first is used
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int64_t idx = tile0 + j * THREADS + threadIdx.x;
        y[c][j] = idx < n ? __ldg(cols.p[c] + idx) : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        stage[j * THREADS + threadIdx.x] = y[c][j];
      __syncthreads();
      const float4 lo = reinterpret_cast<const float4*>(stage)[2 * threadIdx.x];
      const float4 hi =
          reinterpret_cast<const float4*>(stage)[2 * threadIdx.x + 1];
      x[0][c] = lo.x;
      x[1][c] = lo.y;
      x[2][c] = lo.z;
      x[3][c] = lo.w;
      x[4][c] = hi.x;
      x[5][c] = hi.y;
      x[6][c] = hi.z;
      x[7][c] = hi.w;
      __syncthreads();
    }
  }
  Run<NC> mine;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      run = ((fmask >> i) & 1u) ? x[i][c] : run + x[i][c];
      x[i][c] = run;
    }
    mine.v[c] = run;
  }
  mine.f = fmask ? 1 : 0;
  mine.cnt = __popc(fmask);
  const Run<NC> in = carry_in<NC, false>(mine, tile, sc, sh);
  const int nfront = fmask ? __ffs(fmask) - 1 : ITEMS;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i < nfront) {
#pragma unroll
      for (int c = 0; c < NC; ++c) x[i][c] = x[i][c] + in.v[c];
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    reinterpret_cast<float4*>(stage)[2 * threadIdx.x] =
        make_float4(x[0][c], x[1][c], x[2][c], x[3][c]);
    reinterpret_cast<float4*>(stage)[2 * threadIdx.x + 1] =
        make_float4(x[4][c], x[5][c], x[6][c], x[7][c]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t idx = tile0 + j * THREADS + threadIdx.x;
      if (idx < n) out[c * n + idx] = stage[j * THREADS + threadIdx.x];
    }
    __syncthreads();
  }
}

// txr_torch/fusion/offset_map.py:_q: floor(x * 2^bits) clamped to the field.
__device__ __forceinline__ uint32_t quantise(float x, float scale) {
  return static_cast<uint32_t>(
      fminf(fmaxf(floorf(x * scale), 0.f), scale - 1.f));
}

// :_dq: the midpoint of a fixed-point step.  (u + 0.5) * 2^-bits is exact
// and the product by w is one rounding, as in the plain version.
__device__ __forceinline__ float dequantise(uint32_t u, float inv_scale) {
  return (static_cast<float>(u) + 0.5f) * inv_scale;
}

// 140 registers, one block a multiprocessor: held to 128 for two blocks,
// ptxas spills 16 bytes.
__global__ void __launch_bounds__(THREADS, 1)
offset_reduce_kernel(const int64_t* __restrict__ skey,
                     const int64_t* __restrict__ perm,
                     const int32_t* __restrict__ yzw,
                     const int32_t* __restrict__ rgb, int64_t n, int cap,
                     int32_t* __restrict__ okhi, int32_t* __restrict__ oklo,
                     int32_t* __restrict__ oyzw, int32_t* __restrict__ orgb,
                     Scratch sc) {
  __shared__ BlockShared<REDUCE_COLS> sh;
  const int tile = next_tile(sc, sh);
  const int64_t base = static_cast<int64_t>(tile) * TILE +
                       static_cast<int64_t>(threadIdx.x) * ITEMS;
  // Per row only the three packed words stay in registers (x offset,
  // y|z|w, r|g|b); the seven weighted values are unpacked from them once
  // for the thread's aggregate and again, in the same order with the same
  // operations, for the sums at the segment ends, so both passes and the
  // standalone scan of the same columns agree bit for bit.
  uint32_t ux[ITEMS], uy[ITEMS], ur[ITEMS];
  unsigned fmask = 0u, emask = 0u;
  {
    // the sort key (khi << 32) | (klo_x + 2^31): its top 54 bits are the
    // voxel (khi, klo), the low 10 the x offset, which only orders rows
    // inside a voxel
    int64_t key[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t idx = base + i;
      key[i] = idx < n ? __ldg(skey + idx) : 0;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t idx = base + i;
      const int64_t p = idx < n ? __ldg(perm + idx) : 0;
      uy[i] = idx < n ? static_cast<uint32_t>(__ldg(yzw + p)) : 0u;
      ur[i] = idx < n ? static_cast<uint32_t>(__ldg(rgb + p)) : 0u;
    }
    const int64_t prev = base > 0 && base <= n ? __ldg(skey + base - 1) : 0;
    const int64_t next = base + ITEMS < n ? __ldg(skey + base + ITEMS) : 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t idx = base + i;
      const int64_t voxel = key[i] >> 10;
      const int64_t before = (i == 0 ? prev : key[i - 1]) >> 10;
      const int64_t after = (i == ITEMS - 1 ? next : key[i + 1]) >> 10;
      if (idx < n && (idx == 0 || before != voxel)) fmask |= 1u << i;
      if (idx < n && (idx == n - 1 || after != voxel)) emask |= 1u << i;
      ux[i] = static_cast<uint32_t>(key[i]) & 0x3FFu;
    }
  }
  // txr_torch/fusion/offset_map.py:_sorted_contributions, column c of row i
  auto value = [&](int i, int c) -> float {
    const float w = static_cast<float>(uy[i] & 0x7FFu);
    switch (c) {
      case 0: return dequantise(ux[i], 1.f / 1024.f) * w;
      case 1: return dequantise((uy[i] >> 21) & 0x3FFu, 1.f / 1024.f) * w;
      case 2: return dequantise((uy[i] >> 11) & 0x3FFu, 1.f / 1024.f) * w;
      case 3: return dequantise((ur[i] >> 16) & 0xFFu, 1.f / 256.f) * w;
      case 4: return dequantise((ur[i] >> 8) & 0xFFu, 1.f / 256.f) * w;
      case 5: return dequantise(ur[i] & 0xFFu, 1.f / 256.f) * w;
      default: return w;
    }
  };
  Run<REDUCE_COLS> mine;
#pragma unroll
  for (int c = 0; c < REDUCE_COLS; ++c) {
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      run = ((fmask >> i) & 1u) ? value(i, c) : run + value(i, c);
    mine.v[c] = run;
  }
  mine.f = fmask ? 1 : 0;
  mine.cnt = __popc(fmask);
  const Run<REDUCE_COLS> in =
      carry_in<REDUCE_COLS, true>(mine, tile, sc, sh);

  // At each segment end, the voxel's totals; its rank among the voxels is
  // the number of starts up to it, less one.
  const int nfront = fmask ? __ffs(fmask) - 1 : ITEMS;
  float run[REDUCE_COLS];
#pragma unroll
  for (int c = 0; c < REDUCE_COLS; ++c) run[c] = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
#pragma unroll
    for (int c = 0; c < REDUCE_COLS; ++c)
      run[c] = ((fmask >> i) & 1u) ? value(i, c) : run[c] + value(i, c);
    if (!((emask >> i) & 1u)) continue;
    const int rank = in.cnt + __popc(fmask & ((2u << i) - 1u)) - 1;
    if (rank >= cap) continue;  // an overflowing map keeps its lowest keys
    float sum[REDUCE_COLS];
#pragma unroll
    for (int c = 0; c < REDUCE_COLS; ++c)
      sum[c] = i < nfront ? run[c] + in.v[c] : run[c];
    // the key of an end row comes again from L2 rather than staying in
    // sixteen registers through the scan
    const int64_t end_key = __ldcg(skey + base + i);
    const int64_t khi = end_key >> 32;
    const uint32_t klo = static_cast<uint32_t>(end_key) >> 10;
    const float wgt = sum[6];
    const float den = fmaxf(wgt, 1.f);
    float mean[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) mean[c] = __fdiv_rn(sum[c], den);
    const bool occupied = wgt > 0.f && khi != INT32_MAX_;
    const uint32_t wq = static_cast<uint32_t>(
        fminf(fmaxf(wgt, 0.f), static_cast<float>(W_MAX)));
    okhi[rank] = occupied ? static_cast<int32_t>(khi) : INT32_MAX_;
    oklo[rank] = occupied
                     ? static_cast<int32_t>(((klo << 10) |
                                             quantise(mean[0], 1024.f)) ^
                                            0x80000000u)
                     : INT32_MAX_;
    oyzw[rank] = occupied ? static_cast<int32_t>(
                                (quantise(mean[1], 1024.f) << 21) |
                                (quantise(mean[2], 1024.f) << 11) | wq)
                          : 0;
    orgb[rank] = occupied ? static_cast<int32_t>(
                                (quantise(mean[3], 256.f) << 16) |
                                (quantise(mean[4], 256.f) << 8) |
                                quantise(mean[5], 256.f))
                          : 0;
  }
}

int tiles_of(long long n) { return static_cast<int>((n + TILE - 1) / TILE); }

cudaError_t reset(void* iscratch, int tiles, cudaStream_t s) {
  return cudaMemsetAsync(iscratch, 0,
                         (1 + static_cast<size_t>(tiles)) * sizeof(int), s);
}

template <int NC>
cudaError_t launch_scan(const Cols& c, const uint8_t* starts, float* out,
                        int64_t n, const Scratch& sc, int tiles,
                        cudaStream_t s) {
  segscan_kernel<NC><<<tiles, THREADS, 0, s>>>(c, starts, out, n, sc);
  return cudaGetLastError();
}

}  // namespace

// Rows per tile, threads per block, rows per thread, most columns: the
// host side sizes the scratch from these (chip_smoke.py checks them).
extern "C" void txr_segscan_geometry(int* out4) {
  out4[0] = TILE;
  out4[1] = THREADS;
  out4[2] = ITEMS;
  out4[3] = MAX_COLS;
}

// cols: host array of `ncols` device pointers to (n,) f32; starts: (n,) u8;
// out: (ncols, n) f32; iscratch: 1 + 3*tiles i32; fscratch: 16*tiles f32,
// with tiles = ceil(n / TILE).  One memset of the tile states, one launch.
// Returns the first failing call's cudaError_t (0 on success).
extern "C" int txr_segscan_fwd(const void* const* cols, const void* starts,
                               void* out, long long n, int ncols,
                               void* fscratch, void* iscratch, void* stream) {
  if (ncols < 1 || ncols > MAX_COLS || n < 1 || n > 2147483647LL * TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  for (int i = 0; i < MAX_COLS; ++i)
    c.p[i] = static_cast<const float*>(cols[i < ncols ? i : 0]);
  const int tiles = tiles_of(n);
  const Scratch sc = carve(iscratch, fscratch, tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = reset(iscratch, tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* st = static_cast<const uint8_t*>(starts);
  float* o = static_cast<float*>(out);
  switch (ncols) {
    case 1: err = launch_scan<1>(c, st, o, n, sc, tiles, s); break;
    case 2: err = launch_scan<2>(c, st, o, n, sc, tiles, s); break;
    case 3: err = launch_scan<3>(c, st, o, n, sc, tiles, s); break;
    case 4: err = launch_scan<4>(c, st, o, n, sc, tiles, s); break;
    case 5: err = launch_scan<5>(c, st, o, n, sc, tiles, s); break;
    case 6: err = launch_scan<6>(c, st, o, n, sc, tiles, s); break;
    case 7: err = launch_scan<7>(c, st, o, n, sc, tiles, s); break;
    default: err = launch_scan<8>(c, st, o, n, sc, tiles, s); break;
  }
  return static_cast<int>(err);
}

// skey, perm: (n,) int64, the sorted fused key and the sort's permutation;
// yzw, rgb: (n,) int32, the unsorted payload columns; okhi, oklo, oyzw,
// orgb: (cap,) int32, prefilled as an empty map (only the first
// min(voxels, cap) rows are written); scratch as for txr_segscan_fwd.
// Returns the first failing call's cudaError_t (0 on success).
extern "C" int txr_offset_reduce_fwd(const void* skey, const void* perm,
                                     const void* yzw, const void* rgb,
                                     long long n, int cap, void* okhi,
                                     void* oklo, void* oyzw, void* orgb,
                                     void* fscratch, void* iscratch,
                                     void* stream) {
  if (n < 1 || cap < 0 || n > 2147483647LL * TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = tiles_of(n);
  const Scratch sc = carve(iscratch, fscratch, tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = reset(iscratch, tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  offset_reduce_kernel<<<tiles, THREADS, 0, s>>>(
      static_cast<const int64_t*>(skey), static_cast<const int64_t*>(perm),
      static_cast<const int32_t*>(yzw), static_cast<const int32_t*>(rgb), n,
      cap, static_cast<int32_t*>(okhi), static_cast<int32_t*>(oklo),
      static_cast<int32_t*>(oyzw), static_cast<int32_t*>(orgb), sc);
  return static_cast<int>(cudaGetLastError());
}
