// 3x3 convolution, zero padding 1, NHWC, optional ReLU on the input, for
// Hopper.
//
// Replaces the TPU kernel txr/ops/conv_stripe.py:_conv3_kernel:
//   out[b,h,w,f] = bias[f] + sum_{di,dj,c} act(x[b,h+di-1,w+dj-1,c]) *
//                  wgt[di,dj,c,f]
// with act = ReLU when relu_in, x outside the image zero, f32 accumulation,
// f32 bias, and the result in x's type (bf16 here).
//
// Bound on this card: operations.  2*9*C*F flop per output pixel against
// about 2*(C + F) bytes is far above the bf16 ridge at C = 256, so the
// tensor cores are the limit.
//
// Design.  The TPU kernel's flat stripes, two row-block refs and (3, C, 3F)
// packed weight answer that machine's sublane alignment and are not carried
// over.  Here the convolution is an implicit matrix product with the output
// pixels as rows, the features as columns and (tap, channel) as the depth.
// A block owns an 8 x 16 tile of output pixels and 128 features; eight
// warps, each four tile rows (four m16 tiles) by 32 features.  The whole
// 3 x 3 kernel is 9*C*F*2 bytes = 1.18 MB at C = F = 256 and the halo patch
// of all channels 92 KB, so both are chunked through shared memory: the
// depth loop walks channel chunks of 64 and, inside a chunk, the nine taps.
// The (8+2) x (16+2) pixel halo patch of one channel chunk is double
// buffered and serves nine iterations; the (128 features x 64 channels)
// weight slice of one (chunk, tap) goes through a three-slot ring.  All
// copies are 16-byte cp.async; a copy whose source lies outside the image,
// past C or past F has source size 0, which zero fills: that is the conv's
// padding and the ragged edge in one mechanism.  Fragments come from shared
// memory with ldmatrix (rows padded to 144 bytes, conflict free); a tap
// only shifts the patch address.  ReLU is applied to the A fragments in
// registers by clearing the bf16 halves whose sign bit is set.  Products
// are mma.sync.m16n8k16 bf16 with f32 accumulators; bias is added in f32
// and the result rounded once.  H = 74 and W = 132 / 264 / 528 are
// multiples of no tile: pixels past the edge are computed and not stored.
// wgmma, TMA and weight reuse across tiles are left for a later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace {

using namespace txr;

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;                 // tile height in output pixels
constexpr int TW = 16;                // tile width: one m16 tile per row
constexpr int PH = TH + 2;
constexpr int PW = TW + 2;
constexpr int NPIX = PH * PW;         // halo patch pixels
constexpr int CK = 64;                // channels per chunk
constexpr int PITCH = CK + 8;         // shared-memory row pitch in elements
constexpr int BN = 128;               // features per block
constexpr int WSLOTS = 3;
constexpr int NTHREADS = 256;
constexpr int PATCH_ELEMS = NPIX * PITCH;
constexpr int W_ELEMS = BN * PITCH;
constexpr int SMEM_BYTES = (2 * PATCH_ELEMS + WSLOTS * W_ELEMS) * 2;

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  // 0xffff in each half whose sign bit is set
  const uint32_t neg = ((v >> 15) & 0x00010001u) * 0xffffu;
  return v & ~neg;
}

template <bool RELU>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
               const float* __restrict__ bias, bf16* __restrict__ out, int H,
               int W, int C, int F, int nfb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sP = reinterpret_cast<bf16*>(smem_raw);  // 2 x NPIX x PITCH
  bf16* sW = sP + 2 * PATCH_ELEMS;               // WSLOTS x BN x PITCH

  const int tid = threadIdx.x;
  const int b = blockIdx.z / nfb;
  const int f0 = (blockIdx.z - b * nfb) * BN;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const bf16* xb = x + static_cast<int64_t>(b) * H * W * C;
  const int nchunks = (C + CK - 1) / CK;
  const int niter = nchunks * 9;

  auto load_patch = [&](int buf, int cc) {
    bf16* dst = sP + buf * PATCH_ELEMS;
    for (int u = tid; u < NPIX * (CK / 8); u += NTHREADS) {
      const int p = u >> 3;
      const int ch = u & 7;
      const int prow = p / PW;
      const int pcol = p - prow * PW;
      const int iy = ty0 - 1 + prow;
      const int ix = tx0 - 1 + pcol;
      const int c = cc * CK + ch * 8;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && c < C;
      const bf16* src =
          xb + (ok ? (static_cast<int64_t>(iy) * W + ix) * C + c : int64_t(0));
      cp_async16(dst + p * PITCH + ch * 8, src, ok ? 16 : 0);
    }
  };
  auto load_weights = [&](int slot, int it) {
    const int cc = it / 9;
    const int tap = it - cc * 9;
    bf16* dst = sW + slot * W_ELEMS;
    for (int u = tid; u < BN * (CK / 8); u += NTHREADS) {
      const int r = u >> 3;
      const int ch = u & 7;
      const int f = f0 + r;
      const int c = cc * CK + ch * 8;
      const bool ok = f < F && c < C;
      const bf16* src =
          wp + (ok ? (static_cast<int64_t>(tap) * F + f) * C + c : int64_t(0));
      cp_async16(dst + r * PITCH + ch * 8, src, ok ? 16 : 0);
    }
  };

  load_patch(0, 0);
  load_weights(0, 0);
  cp_async_commit();
  if (niter > 1) load_weights(1, 1);
  cp_async_commit();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;  // 0..1: tile rows 4*wm .. 4*wm+3
  const int wn = warp & 3;   // 0..3: features 32*wn .. 32*wn+31

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // lane-constant parts of the ldmatrix addresses (elements)
  const int a_off = (wm * 4 * PW + (lane & 15)) * PITCH + (lane >> 4) * 8;
  const int b_off =
      (wn * 32 + (lane & 7) + ((lane >> 4) & 1) * 8) * PITCH +
      ((lane >> 3) & 1) * 8;

  for (int it = 0; it < niter; ++it) {
    const int cc = it / 9;
    const int tap = it - cc * 9;
    cp_async_wait<1>();  // all but the newest group: iteration `it` landed
    __syncthreads();     // ... for every thread; iteration it-1 is done
    if (it + 2 < niter) load_weights((it + 2) % WSLOTS, it + 2);
    if (tap == 0 && cc + 1 < nchunks) load_patch((cc + 1) & 1, cc + 1);
    cp_async_commit();

    const int di = tap / 3;
    const int dj = tap - di * 3;
    const bf16* pa = sP + (cc & 1) * PATCH_ELEMS + a_off +
                     (di * PW + dj) * PITCH;
    const bf16* pb = sW + (it % WSLOTS) * W_ELEMS + b_off;
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      uint32_t af[4][4];
      uint32_t bq[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        ldmatrix_x4(af[mt], pa + mt * PW * PITCH + kk * 16);
        if (RELU) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[mt][i] = relu_bf16x2(af[mt][i]);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, pb + np * 16 * PITCH + kk * 16);
        bq[2 * np][0] = r[0];
        bq[2 * np][1] = r[1];
        bq[2 * np + 1][0] = r[2];
        bq[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bq[nt][0], bq[nt][1]);
    }
  }
  cp_async_wait<0>();

  bf16* ob = out + static_cast<int64_t>(b) * H * W * F;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int f = f0 + wn * 32 + nt * 8 + t * 2;
    if (f >= F) continue;  // F is even, so f + 1 < F as well
    const float b0 = bias[f], b1 = bias[f + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int oy = ty0 + wm * 4 + mt;
      if (oy >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = tx0 + g + half * 8;
        if (ox >= W) continue;
        const __nv_bfloat162 y = __floats2bfloat162_rn(
            acc[mt][nt][2 * half] + b0, acc[mt][nt][2 * half + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(
            ob + (static_cast<int64_t>(oy) * W + ox) * F + f) = y;
      }
    }
  }
}

template <bool RELU>
int launch(const bf16* x, const bf16* wp, const float* bias, bf16* out, int B,
           int H, int W, int C, int F, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nfb = (F + BN - 1) / BN;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nfb);
  conv3x3_kernel<RELU><<<grid, NTHREADS, SMEM_BYTES, st>>>(x, wp, bias, out, H,
                                                          W, C, F, nfb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, C) bf16 NHWC contiguous; wp: (9, F, C) bf16 (tap = 3*di + dj,
// feature, channel); bias: (F,) f32; out: (B, H, W, F) bf16.  C and F
// multiples of 8, all pointers 16-byte aligned, B * ceil(F/128) <= 65535,
// ceil(H/8) <= 65535.  Returns the launch's cudaError_t (0 on success).
extern "C" int txr_conv3x3_fwd(const void* x, const void* wp, const void* bias,
                               void* out, int B, int H, int W, int C, int F,
                               int relu_in, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wpp = static_cast<const bf16*>(wp);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  return relu_in ? launch<true>(xp, wpp, bp, op, B, H, W, C, F, st)
                 : launch<false>(xp, wpp, bp, op, B, H, W, C, F, st);
}
