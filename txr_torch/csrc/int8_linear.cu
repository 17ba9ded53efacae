// W8A8 linear layer with dynamic per-row activation scales, for Hopper.
//
// Replaces the TPU kernel txr/ops/quant_pallas.py:_kernel:
//   sx[m]   = max(max_k |x[m,k]| / 127, 1e-12)
//   xq[m,k] = round_half_even(x[m,k] / sx[m])                     (int8)
//   y[m,n]  = bf16( float(sum_k xq[m,k] * wq[n,k]) * (sx[m] * sw[n]) + b[n] )
// with wq (int8) and sw (f32) quantised per output column outside, bf16 x in
// and bf16 y out.
//
// Bound on this card: operations.  2*M*K*N int8 operations against
// 2*M*K + K*N + 2*M*N bytes is far above the int8 ridge at every shape of
// the ViT (M = 19,544 rows), so the tensor cores are the limit; only wgmma
// reaches their full rate.  The quantise pass in front is bound by bytes
// (2 in, 1 out per element).
//
// Design.  The TPU kernel keeps a whole (256, K) row block in its fast
// memory and re-quantises it for every tile of N.  A (128, 4096) bf16 block
// is 1 MB and does not fit a Hopper block's shared memory, and the row
// maximum needs the whole row before the first product, so the work is two
// kernels behind one entry point:
//   1. quantize_rows_kernel: one warp per 1024 values of a row (one to
//      eight warps a row, meeting through shared memory).  A lane keeps its
//      four 16-byte pieces in registers between the |x| reduction and the
//      quantisation, so the row is read once and a thread needs few
//      registers (K <= 8192; a longer row is read a second time, from
//      cache).  x / sx is a true division (__fdiv_rn) and the rounding is
//      to nearest even (__float2int_rn), as in the reference.  Writes int8
//      xq (M, K) and f32 sx (M,).
//   2. int8_gemm_kernel: a persistent grid, one block per SM, walks the
//      128 x 256 output tiles with the column tile running fastest, so the
//      blocks of one wave share a few row tiles of xq while the whole weight
//      (at most 4 MB here) stays in L2.
//      * Products: wgmma m64n256k32 s8 x s8 -> s32, both operands from
//        shared memory.  xq (M, K) and wq (N, K) are both K-major, which is
//        the only layout 8-bit wgmma takes and nn.Linear's own.  Two
//        consumer warpgroups own 64 rows of the tile each (128 s32
//        accumulators per thread).
//      * Loads: one thread of a producer warpgroup issues TMA loads of
//        128 bytes of K per stage (a 128-row box of xq, a 256-row box of wq,
//        128-byte swizzle) into a four-stage mbarrier ring and runs ahead
//        into the next tile; setmaxnreg moves its registers to the
//        consumers.  Rows past M or N and bytes past K arrive as zeros from
//        the tensor map: that is the whole of the edge handling on the load
//        side.
//      * A stage's four wgmma form one group; a consumer waits for the group
//        before it (wait_group 1) to hand that stage back, so two groups are
//        always in flight and no product is issued under a condition.
//      * Epilogue: float(acc) * (sx * sw) + b with separate f32 multiply,
//        multiply, add (no fused multiply-add, so the rounding is the
//        reference's), one rounding to bf16.  The tile's column scales and
//        biases are copied to shared memory, and a thread's two row scales
//        to registers, before the tile's products start, so the epilogue
//        waits for no load.  A warp stages its 16 rows by 64 columns in
//        shared memory (16-byte pieces XOR-swizzled by row, conflict free)
//        and stores rows of 128 contiguous bytes with 16-byte stores, masked
//        at the M and N edges.  The producer meanwhile loads the next
//        tile's first stages.
// The integer sums are exact and the epilogue is the reference's, so the
// result equals int8_linear_reference bit for bit.  No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_utils.cuh"

namespace {

using namespace txr;

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;            // output rows per tile: 64 per warpgroup
constexpr int BN = 256;            // output columns per tile
constexpr int BK = 128;            // bytes (int8 values) of K per stage
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;      // two consumer warpgroups + the producer's
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_COLS = 64;       // columns a warp stages at a time
constexpr int EPI_WARP_BYTES = 16 * EPI_COLS * 2;
constexpr int EPI_BYTES = 8 * EPI_WARP_BYTES;
constexpr int SCALE_BYTES = 2 * 2 * BN * 4;  // sw and bias, per warpgroup
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + EPI_BYTES +
                           SCALE_BYTES + 2 * STAGES * 8;  // 1024: alignment
constexpr int QWARPS = 8;          // warps per block of the quantise kernel

// ------------------------------------------------------------- quantise

__device__ __forceinline__ float amax8(const uint4& u, float amax) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
  return amax;
}

__device__ __forceinline__ uint2 quantize8(const uint4& u, float s) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    const int q0 = __float2int_rn(__fdiv_rn(v.x, s));
    const int q1 = __float2int_rn(__fdiv_rn(v.y, s));
    const uint32_t pair = (static_cast<uint32_t>(q0) & 0xffu) |
                          ((static_cast<uint32_t>(q1) & 0xffu) << 8);
    w[i >> 1] |= pair << ((i & 1) * 16);
  }
  return make_uint2(w[0], w[1]);
}

// Rows of up to 8192 values: WPR warps share a row (1024 values each), a
// lane keeps its four 16-byte pieces in registers between the |x| reduction
// and the quantisation, and the warps of a row meet through shared memory.
// Few registers a thread, so that many rows are in flight per SM.
template <int WPR>
__global__ void __launch_bounds__(QWARPS * 32)
quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int K) {
  __shared__ float part[QWARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = warp % WPR;  // which 1024 values of the row
  const int row = blockIdx.x * (QWARPS / WPR) + warp / WPR;
  const bool live = row < M;   // no early return: the block meets below
  const int chunks = K >> 3;   // 8 bf16 = 16 bytes
  const int64_t off = static_cast<int64_t>(live ? row : 0) * K;
  const uint4* xr = reinterpret_cast<const uint4*>(x + off);

  uint4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = (sub * 4 + i) * 32 + lane;
    v[i] = live && c < chunks ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) amax = amax8(v[i], amax);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (WPR > 1) {
    if (lane == 0) part[warp] = amax;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < WPR; ++j) amax = fmaxf(amax, part[warp - sub + j]);
  }
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  if (!live) return;
  if (sub == 0 && lane == 0) sx[row] = s;
  uint2* qr = reinterpret_cast<uint2*>(xq + off);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = (sub * 4 + i) * 32 + lane;
    if (c < chunks) qr[c] = quantize8(v[i], s);
  }
}

// Longer rows: one warp per row reads it twice (the second time from cache).
__global__ void __launch_bounds__(QWARPS * 32)
quantize_long_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                          float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * QWARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * K);
  uint2* qr = reinterpret_cast<uint2*>(xq + static_cast<int64_t>(row) * K);
  const int chunks = K >> 3;
  float amax = 0.f;
  for (int c = lane; c < chunks; c += 32) amax = amax8(xr[c], amax);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  if (lane == 0) sx[row] = s;
  for (int c = lane; c < chunks; c += 32) qr[c] = quantize8(xr[c], s);
}

template <int WPR>
void launch_quantize_wpr(const bf16* x, int8_t* xq, float* sx, int M, int K,
                         cudaStream_t st) {
  constexpr int rows = QWARPS / WPR;
  // the product kernel that follows takes the whole shared-memory carveout:
  // asking for the same here spares the SMs a reconfiguration between them
  cudaFuncSetAttribute(quantize_rows_kernel<WPR>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  quantize_rows_kernel<WPR><<<(M + rows - 1) / rows, QWARPS * 32, 0, st>>>(
      x, xq, sx, M, K);
}

int launch_quantize(const bf16* x, int8_t* xq, float* sx, int M, int K,
                    cudaStream_t st) {
  if (K <= 1024)
    launch_quantize_wpr<1>(x, xq, sx, M, K, st);
  else if (K <= 2048)
    launch_quantize_wpr<2>(x, xq, sx, M, K, st);
  else if (K <= 4096)
    launch_quantize_wpr<4>(x, xq, sx, M, K, st);
  else if (K <= 8192)
    launch_quantize_wpr<8>(x, xq, sx, M, K, st);
  else
    quantize_long_rows_kernel<<<(M + QWARPS - 1) / QWARPS, QWARPS * 32, 0,
                                st>>>(x, xq, sx, M, K);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- GEMM

// Barrier among the 128 threads of consumer warpgroup `wg` (barrier 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__global__ void __launch_bounds__(NTHREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, bf16* __restrict__ out, int M,
                 int K, int N, int n_tiles, int total_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sStage = base;                       // STAGES x (A, B)
  unsigned char* sEpi = base + STAGES * STAGE_BYTES;  // 8 warps x 2 KB
  float* sScale = reinterpret_cast<float*>(sEpi + EPI_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sEpi + EPI_BYTES + SCALE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int ktiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // lane 0 of each of the 8 consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    reg_dealloc<40>();
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
        const int mt = tile / n_tiles;
        const int m0 = mt * BM;
        const int n0 = (tile - mt * n_tiles) * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int slot = it % STAGES;
          mbar_wait(empty + slot, ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full + slot, STAGE_BYTES);
          unsigned char* st = sStage + slot * STAGE_BYTES;
          tma_load_2d(st, &map_a, full + slot, kt * BK, m0);
          tma_load_2d(st + A_BYTES, &map_b, full + slot, kt * BK, n0);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    reg_alloc<232>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    unsigned char* stage_w = sEpi + (wg * 4 + warp) * EPI_WARP_BYTES;
    float* s_sw = sScale + wg * (2 * BN);  // this warpgroup's copy
    float* s_bias = s_sw + BN;
    const int wt = tid & 127;

    int acc[128];
    int it = 0;
    for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
      const int mt = tile / n_tiles;
      const int m0 = mt * BM;
      const int n0 = (tile - mt * n_tiles) * BN;

      // What the epilogue needs besides the sums, fetched before the
      // products so that its latency is hidden: the tile's column scales and
      // biases into shared memory, this thread's two row scales.
#pragma unroll
      for (int i = 0; i < BN / 128; ++i) {
        const int col = n0 + wt + i * 128;
        s_sw[wt + i * 128] = col < N ? __ldg(sw + col) : 0.f;
        s_bias[wt + i * 128] = col < N ? __ldg(bias + col) : 0.f;
      }
      const int row_w = m0 + wg * 64 + warp * 16;  // the warp's first row
      const float s0 = row_w + g < M ? __ldg(sx + row_w + g) : 0.f;
      const float s1 = row_w + g + 8 < M ? __ldg(sx + row_w + g + 8) : 0.f;

      fence_operands(acc);
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int slot = it % STAGES;
        mbar_wait(full + slot, (it / STAGES) & 1);
        const unsigned char* st = sStage + slot * STAGE_BYTES;
        const uint64_t a_desc = wgmma_desc_sw128(st + wg * (64 * BK));
        const uint64_t b_desc = wgmma_desc_sw128(st + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_m64n256k32_s8_ss(acc, a_desc + 2 * kk, b_desc + 2 * kk,
                                 (kt | kk) != 0);
        wgmma_commit();
        // the group before this one is done: its stage goes back
        wgmma_wait<1>();
        if (kt > 0 && lane == 0)
          mbar_arrive(empty + (it + STAGES - 1) % STAGES);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty + (it + STAGES - 1) % STAGES);
      warpgroup_sync(wg);  // the warpgroup's scales and biases are written

      // y = float(acc) * (sx * sw) + b, one rounding to bf16
#pragma unroll
      for (int part = 0; part < BN / EPI_COLS; ++part) {
        __syncwarp();  // the staging area's last readers are done
#pragma unroll
        for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
          const int j = part * (EPI_COLS / 8) + jj;
          const float2 w2 =
              *reinterpret_cast<const float2*>(s_sw + j * 8 + t * 2);
          const float2 b2 =
              *reinterpret_cast<const float2*>(s_bias + j * 8 + t * 2);
          const float y00 = __fadd_rn(
              __fmul_rn(static_cast<float>(acc[4 * j]), __fmul_rn(s0, w2.x)),
              b2.x);
          const float y01 = __fadd_rn(
              __fmul_rn(static_cast<float>(acc[4 * j + 1]),
                        __fmul_rn(s0, w2.y)),
              b2.y);
          const float y10 = __fadd_rn(
              __fmul_rn(static_cast<float>(acc[4 * j + 2]),
                        __fmul_rn(s1, w2.x)),
              b2.x);
          const float y11 = __fadd_rn(
              __fmul_rn(static_cast<float>(acc[4 * j + 3]),
                        __fmul_rn(s1, w2.y)),
              b2.y);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(y00, y01);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(y10, y11);
          // rows g and g + 8 share (row & 7): one swizzled piece index
          const int off = ((jj ^ g) << 4) + t * 4;
          *reinterpret_cast<__nv_bfloat162*>(stage_w + g * (EPI_COLS * 2) +
                                             off) = lo;
          *reinterpret_cast<__nv_bfloat162*>(
              stage_w + (g + 8) * (EPI_COLS * 2) + off) = hi;
        }
        __syncwarp();
        // 8 lanes x 16 bytes are one row of 64 columns: four rows a store
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * i + (lane >> 3);
          const int c = lane & 7;
          const uint4 v = *reinterpret_cast<const uint4*>(
              stage_w + r * (EPI_COLS * 2) + ((c ^ (r & 7)) << 4));
          const int grow = row_w + r;
          const int gcol = n0 + part * EPI_COLS + c * 8;
          if (grow < M && gcol < N)
            *reinterpret_cast<uint4*>(out + static_cast<int64_t>(grow) * N +
                                      gcol) = v;
        }
      }
      warpgroup_sync(wg);  // before the next tile's scales overwrite these
    }
  }
}

int launch_gemm(const int8_t* xq, const int8_t* wq, const float* sx,
                const float* sw, const float* bias, bf16* out, int M, int K,
                int N, int sms, cudaStream_t st) {
  CUtensorMap ma, mb;
  const uint64_t stride[1] = {static_cast<uint64_t>(K)};
  {
    const uint64_t dims[2] = {static_cast<uint64_t>(K),
                              static_cast<uint64_t>(M)};
    const uint32_t box[2] = {BK, BM};
    const int rc = encode_u8_map(&ma, xq, 2, dims, stride, box);
    if (rc != 0) return rc;
  }
  {
    const uint64_t dims[2] = {static_cast<uint64_t>(K),
                              static_cast<uint64_t>(N)};
    const uint32_t box[2] = {BK, BN};
    const int rc = encode_u8_map(&mb, wq, 2, dims, stride, box);
    if (rc != 0) return rc;
  }
  // per launch: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      int8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_tiles = (N + BN - 1) / BN;
  const int64_t total = static_cast<int64_t>((M + BM - 1) / BM) * n_tiles;
  if (sms < 1 || total > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = total < sms ? static_cast<int>(total) : sms;
  int8_gemm_kernel<<<grid, NTHREADS, SMEM_BYTES, st>>>(
      ma, mb, sx, sw, bias, out, M, K, N, n_tiles, static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Geometry of the product kernel, for the host side to check against: tile
// rows, tile columns, stages, dynamic shared-memory bytes.
extern "C" void txr_int8_linear_geometry(int* out4) {
  out4[0] = BM;
  out4[1] = BN;
  out4[2] = STAGES;
  out4[3] = SMEM_BYTES;
}

// The two halves of txr_int8_linear_fwd on their own, so that each can be
// timed.  x: (M, K) bf16; xq: (M, K) int8; sx: (M,) f32.
extern "C" int txr_int8_quantize_rows(const void* x, void* xq, void* sx, int M,
                                      int K, void* stream) {
  return launch_quantize(static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
                         static_cast<float*>(sx), M, K,
                         static_cast<cudaStream_t>(stream));
}

// xq: (M, K) int8; wq: (N, K) int8; sx: (M,), sw, bias: (N,) f32; out:
// (M, N) bf16; sms: blocks of the persistent grid at most.
extern "C" int txr_int8_gemm(const void* xq, const void* wq, const void* sx,
                             const void* sw, const void* bias, void* out,
                             int M, int K, int N, int sms, void* stream) {
  return launch_gemm(static_cast<const int8_t*>(xq),
                     static_cast<const int8_t*>(wq),
                     static_cast<const float*>(sx),
                     static_cast<const float*>(sw),
                     static_cast<const float*>(bias), static_cast<bf16*>(out),
                     M, K, N, sms, static_cast<cudaStream_t>(stream));
}

// x: (M, K) bf16 contiguous; wq: (N, K) int8 contiguous; sw, bias: (N,) f32;
// xq: (M, K) int8 scratch; sx: (M,) f32 scratch; out: (M, N) bf16.
// K a multiple of 16, N a multiple of 8, all pointers 16-byte aligned; sms:
// the device's multiprocessor count (the persistent grid's size at most).
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int txr_int8_linear_fwd(const void* x, const void* wq,
                                   const void* sw, const void* bias, void* xq,
                                   void* sx, void* out, int M, int K, int N,
                                   int sms, void* stream) {
  const int rc = txr_int8_quantize_rows(x, xq, sx, M, K, stream);
  if (rc != 0) return rc;
  return txr_int8_gemm(xq, wq, sx, sw, bias, out, M, K, N, sms, stream);
}
