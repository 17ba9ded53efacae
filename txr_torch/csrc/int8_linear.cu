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
// the ViT (M = 19,544 rows), so the tensor cores are the limit.
//
// Design.  The TPU kernel keeps a whole (256, K) row block in its fast
// memory and re-quantises it for every tile of N.  A (128, 4096) bf16 block
// is 1 MB and does not fit a Hopper block's shared memory, and the row
// maximum needs the whole row before the first product, so the work is two
// kernels behind one entry point:
//   1. quantize_rows_kernel: one warp per row reads the row twice (the
//      second read comes from cache), reduces |x| with shuffles, and writes
//      int8 xq (M, K) and f32 sx (M,).  x / sx is a true division
//      (__fdiv_rn) and the rounding is to nearest even (__float2int_rn), as
//      in the reference.
//   2. int8_gemm_kernel: 128 x 128 output tile per block, eight warps of
//      64 x 32, K streamed in 64-byte slices through a four-stage cp.async
//      ring; fragments come out of shared memory with ldmatrix (rows padded
//      to 80 bytes, which keeps the eight 16-byte rows of a matrix on
//      distinct banks) and feed mma.sync.m16n8k32 s8 x s8 -> s32.  The
//      epilogue rescales in f32 with separate multiply and add (no fused
//      multiply-add, so the rounding is the reference's) and rounds once to
//      bf16.  wq is (N, K) with K contiguous, which is nn.Linear's own
//      weight layout and the "col" operand of the mma.
// M, N and K are multiples of no tile in general: rows and columns past the
// edge are zero filled on load and masked on store, and a short last K
// slice is zero filled.  wgmma and TMA are left for a later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace {

using namespace txr;

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;            // output rows per block
constexpr int BN = 128;            // output columns per block
constexpr int BK = 64;             // int8 elements of K per stage
constexpr int PITCH = BK + 16;     // shared-memory row pitch in bytes
constexpr int STAGES = 4;
constexpr int NTHREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * PITCH;
constexpr int QROWS = 8;           // rows per block of the quantise kernel

__global__ void quantize_rows_kernel(const bf16* __restrict__ x,
                                     int8_t* __restrict__ xq,
                                     float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * K);
  const int chunks = K >> 3;  // 8 bf16 = 16 bytes

  float amax = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 u = xr[c];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(p[i]);
      amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  if (lane == 0) sx[row] = s;

  uint2* qr = reinterpret_cast<uint2*>(xq + static_cast<int64_t>(row) * K);
  for (int c = lane; c < chunks; c += 32) {
    const uint4 u = xr[c];
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
    qr[c] = make_uint2(w[0], w[1]);
  }
}

// Copies a (rows x BK) int8 tile whose first row is `row0` and first column
// `k0` into shared memory; rows at or past `nrows` and 16-byte pieces at or
// past K are zero filled.
__device__ __forceinline__ void load_tile(unsigned char* smem,
                                          const int8_t* gmem, int row0,
                                          int nrows, int k0, int K) {
  for (int c = threadIdx.x; c < BM * (BK / 16); c += NTHREADS) {
    const int r = c >> 2;
    const int ch = c & 3;
    const int gr = row0 + r;
    const int gk = k0 + ch * 16;
    const bool ok = gr < nrows && gk < K;
    const int8_t* src =
        gmem + (ok ? static_cast<int64_t>(gr) * K + gk : int64_t(0));
    cp_async16(smem + r * PITCH + ch * 16, src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, bf16* __restrict__ out, int M,
                 int K, int N) {
  static_assert(BM == BN, "load_tile assumes square tiles");
  extern __shared__ __align__(16) unsigned char smem[];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;  // 0..1: which 64 rows of the tile
  const int wn = warp & 3;   // 0..3: which 32 columns
  const int ktiles = (K + BK - 1) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      unsigned char* st = smem + s * STAGE_BYTES;
      load_tile(st, xq, m0, M, s * BK, K);
      load_tile(st + BM * PITCH, wq, n0, N, s * BK, K);
    }
    cp_async_commit();
  }

  // lane-constant parts of the ldmatrix addresses
  const int a_row = wm * 64 + (lane & 15);
  const int a_col = (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // the group that carries slice kt landed
    __syncthreads();              // ... for every thread; slice kt-1 is done
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) {
      unsigned char* st = smem + (nk % STAGES) * STAGE_BYTES;
      load_tile(st, xq, m0, M, nk * BK, K);
      load_tile(st + BM * PITCH, wq, n0, N, nk * BK, K);
    }
    cp_async_commit();

    const unsigned char* sA = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* sB = sA + BM * PITCH;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4];
      uint32_t bq[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], sA + (a_row + mt * 16) * PITCH + ks * 32 + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, sB + (b_row + np * 16) * PITCH + ks * 32 + b_col);
        bq[2 * np][0] = r[0];
        bq[2 * np][1] = r[1];
        bq[2 * np + 1][0] = r[2];
        bq[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8_16832(acc[mt][nt], af[mt], bq[nt][0], bq[nt][1]);
    }
  }
  cp_async_wait<0>();

  // y = float(acc) * (sx * sw) + b, one rounding to bf16
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + t * 2;
    if (col >= N) continue;  // N is even, so col + 1 < N as well
    const float sw0 = sw[col], sw1 = sw[col + 1];
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        const float s = sx[row];
        const float y0 = __fadd_rn(
            __fmul_rn(static_cast<float>(acc[mt][nt][2 * half]),
                      __fmul_rn(s, sw0)),
            b0);
        const float y1 = __fadd_rn(
            __fmul_rn(static_cast<float>(acc[mt][nt][2 * half + 1]),
                      __fmul_rn(s, sw1)),
            b1);
        const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<int64_t>(row) * N + col) = y;
      }
    }
  }
}

}  // namespace

// x: (M, K) bf16 contiguous; wq: (N, K) int8 contiguous; sw, bias: (N,) f32;
// xq: (M, K) int8 scratch; sx: (M,) f32 scratch; out: (M, N) bf16.
// K a multiple of 16, N a multiple of 8, all pointers 16-byte aligned.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int txr_int8_linear_fwd(const void* x, const void* wq,
                                   const void* sw, const void* bias, void* xq,
                                   void* sx, void* out, int M, int K, int N,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<<<(M + QROWS - 1) / QROWS, QROWS * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem = STAGES * STAGE_BYTES;
  err = cudaFuncSetAttribute(int8_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, NTHREADS, smem, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<bf16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
