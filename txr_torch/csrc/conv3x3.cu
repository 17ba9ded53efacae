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
// tensor cores are the limit.  What stands in their way is operand traffic:
// the whole 3 x 3 kernel is 9*C*F*2 bytes = 1.18 MB at C = F = 256, far more
// than shared memory, so every block streams its weight slices from L2, and
// the fewer output pixels a block owns the more weight bytes each flop
// costs.
//
// Design.  The TPU kernel's flat stripes, two row-block refs and (3, C, 3F)
// packed weight answer that machine's sublane alignment and are not carried
// over.  Here the convolution is an implicit matrix product with the output
// pixels as rows, the features as columns and (tap, channel) as the depth.
//   * A block owns a 16 x 16 tile of output pixels and 128 features: 256
//     rows per 16 KB weight slice, twice the reuse of a 128-pixel tile, so
//     the weight bytes per flop are halved.  Two consumer warpgroups take
//     eight tile rows each, as two 64-row wgmma tiles (four tile rows of 16
//     pixels; a warp's 16 rows are one tile row).
//   * The products are wgmma m64n128k16 with f32 accumulators (128 per
//     thread).  The weights are the B operand straight from shared memory:
//     (9, F, C) packed, C contiguous, so a 64-channel slice of 128 features
//     is 128 rows of 128 bytes under the 128-byte swizzle.  The pixels are
//     the A operand from registers: a tap is an address shift of whole
//     pixels in the halo patch, which no shared-memory descriptor can
//     express for 64 rows spanning four tile rows, while ldmatrix takes a
//     row address per lane; and ReLU is applied to the fragments in
//     registers (one max.bf16x2 against zero per register).  Two
//     fragment sets alternate, so the loads of one depth step (a tap of a
//     chunk: eight wgmma) run under the products of the step before.
//   * Loads are off the compute warps: one thread of a producer warpgroup
//     starts TMA loads, completion arrives on mbarriers, and setmaxnreg
//     hands its registers to the consumers (24 / 240).  The (16+2) x (16+2)
//     pixel halo patch of one 64-channel chunk is one 4-D box over
//     (C, W, H, B), double buffered; it serves nine taps.  A box that
//     reaches outside the image, negative coordinates included, or past C
//     is zero filled: that is the conv's padding, the ragged tile edge and
//     the short last chunk in one mechanism.  The weight slice of one
//     (chunk, tap) is a 3-D box over (C, F, 9), zero filled past C and F,
//     through a four-slot ring.
//   * Bias is added in f32 and the result rounded once.  H = 74 and W = 132
//     are multiples of no tile: pixels past the edge are computed and not
//     stored.  No atomics: results repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"
#include "wgmma_utils.cuh"

namespace {

using namespace txr;

typedef __nv_bfloat16 bf16;

constexpr int TH = 16;                // tile height in output pixels
constexpr int TW = 16;                // tile width: one warp's 16 rows
constexpr int PH = TH + 2;
constexpr int PW = TW + 2;
constexpr int NPIX = PH * PW;         // halo patch pixels
constexpr int CK = 64;                // channels per chunk: 128-byte rows
constexpr int BN = 128;               // features per block
constexpr int WSLOTS = 4;
constexpr int NTHREADS = 384;         // two consumer warpgroups + producer
constexpr int PATCH_TX = NPIX * CK * 2;                    // bytes per box
constexpr int PATCH_BYTES = (PATCH_TX + 1023) / 1024 * 1024;
constexpr int W_BYTES = BN * CK * 2;
constexpr int SMEM_BYTES =
    1024 + 2 * PATCH_BYTES + WSLOTS * W_BYTES + 64 * 8;  // 1024: alignment

// ReLU of two packed bf16 values: one max against +0.
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(0u));
  return r;
}

template <bool RELU>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const float* __restrict__ bias, bf16* __restrict__ out, int H,
               int W, int C, int F, int nfb) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sP = base;                       // 2 x NPIX rows of 128 B
  unsigned char* sW = sP + 2 * PATCH_BYTES;       // WSLOTS x BN rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(sW + WSLOTS * W_BYTES);
  uint64_t* full_p = bars;
  uint64_t* empty_p = bars + 2;
  uint64_t* full_w = bars + 4;
  uint64_t* empty_w = full_w + WSLOTS;

  const int tid = threadIdx.x;
  const int b = blockIdx.z / nfb;
  const int f0 = (blockIdx.z - b * nfb) * BN;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int nchunks = (C + CK - 1) / CK;
  const int niter = nchunks * 9;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_p + i, 1);
      mbar_init(empty_p + i, 8);  // lane 0 of each of the 8 consumer warps
    }
    for (int i = 0; i < WSLOTS; ++i) {
      mbar_init(full_w + i, 1);
      mbar_init(empty_w + i, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    reg_dealloc<24>();
    if (tid == 256) {
      auto load_patch = [&](int cc) {
        const int buf = cc & 1;
        mbar_wait(empty_p + buf, ((cc >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full_p + buf, PATCH_TX);
        tma_load_4d(sP + buf * PATCH_BYTES, &map_x, full_p + buf, cc * CK,
                    tx0 - 1, ty0 - 1, b);
      };
      load_patch(0);
      for (int it = 0; it < niter; ++it) {
        const int cc = it / 9;
        const int tap = it - cc * 9;
        const int slot = it % WSLOTS;
        mbar_wait(empty_w + slot, ((it / WSLOTS) & 1) ^ 1);
        mbar_arrive_expect_tx(full_w + slot, W_BYTES);
        tma_load_3d(sW + slot * W_BYTES, &map_w, full_w + slot, cc * CK, f0,
                    tap);
        // the next chunk's patch, once this chunk's last slice is under
        // way: its buffer was freed when the chunk before this one ended
        if (tap == 8 && cc + 1 < nchunks) load_patch(cc + 1);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    reg_alloc<240>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;

    // acc[m]: tile rows wg*8 + m*4 + warp, 16 pixels x 128 features
    float acc[2][64];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    // A fragments of the two 64-row tiles, two sets: the products of one
    // depth step read one set while the loads of the next fill the other
    uint32_t fa[2][4][4], fb[2][4][4];

    // A fragments of tile row `row` shifted by a tap: lane l addresses
    // pixel (l & 15) of the row, channel half (l >> 4) of each 16-channel
    // step; the 16-byte chunk index is swizzled with the patch row.
    auto load_a = [&](uint32_t (&a)[4][4], const unsigned char* patch,
                      int row, int di, int dj) {
      const int p = (row + di) * PW + (lane & 15) + dj;
      const unsigned char* prow = patch + p * 128;
      const int sw = p & 7;
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        ldmatrix_x4(a[kk], prow + (((kk * 2 + (lane >> 4)) ^ sw) << 4));
        if (RELU) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[kk][i] = relu_bf16x2(a[kk][i]);
        }
      }
    };
    const int row0 = wg * 8 + warp;  // tile row of acc[0]; acc[1]: + 4
    // Both tiles' fragments for depth step `it` (waits for the chunk's
    // patch at its first tap).
    auto load_step = [&](uint32_t (&f)[2][4][4], int it) {
      const int cc = it / 9;
      const int tap = it - cc * 9;
      const int di = tap / 3;
      const int dj = tap - di * 3;
      if (tap == 0) mbar_wait(full_p + (cc & 1), (cc >> 1) & 1);
      const unsigned char* patch = sP + (cc & 1) * PATCH_BYTES;
      load_a(f[0], patch, row0, di, dj);
      load_a(f[1], patch, row0 + 4, di, dj);
    };
    // Depth step `it`: its eight products from `cur`, and under them the
    // loads of step it + 1 into `nxt`.  The step ends with every product
    // done: the assembler serialises wgmma whose input registers are
    // written while any group of the same stage is still open, so a set is
    // only refilled after a full wait.
    auto step = [&](int it, uint32_t (&cur)[2][4][4],
                    uint32_t (&nxt)[2][4][4]) {
      const int slot = it % WSLOTS;
      mbar_wait(full_w + slot, (it / WSLOTS) & 1);
      const uint64_t w_desc = wgmma_desc_sw128(sW + slot * W_BYTES);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_operands(cur[m][kk]);
        fence_operands(acc[m]);
      }
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk)
          wgmma_m64n128k16_rs(acc[m], cur[m][kk], w_desc + 2 * kk, 1);
      wgmma_commit();
      if (it + 1 < niter) load_step(nxt, it + 1);
      wgmma_wait<0>();
      fence_operands(acc[0]);
      fence_operands(acc[1]);
      if (lane == 0) {
        mbar_arrive(empty_w + slot);
        if (it % 9 == 8) mbar_arrive(empty_p + ((it / 9) & 1));
      }
    };

    load_step(fa, 0);
    int it = 0;
    for (; it + 1 < niter; it += 2) {
      step(it, fa, fb);
      step(it + 1, fb, fa);
    }
    if (it < niter) step(it, fa, fb);

    bf16* ob = out + static_cast<int64_t>(b) * H * W * F;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int oy = ty0 + row0 + 4 * m;
      if (oy >= H) continue;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int f = f0 + nt * 8 + t * 2;
        if (f >= F) continue;  // F is even, so f + 1 < F as well
        const float b0 = bias[f], b1 = bias[f + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ox = tx0 + g + half * 8;
          if (ox >= W) continue;
          const __nv_bfloat162 y = __floats2bfloat162_rn(
              acc[m][4 * nt + 2 * half] + b0,
              acc[m][4 * nt + 2 * half + 1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(
              ob + (static_cast<int64_t>(oy) * W + ox) * F + f) = y;
        }
      }
    }
  }
}

template <bool RELU>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const float* bias,
           bf16* out, int B, int H, int W, int C, int F, cudaStream_t st) {
  // per launch: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_kernel<RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nfb = (F + BN - 1) / BN;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nfb);
  conv3x3_kernel<RELU><<<grid, NTHREADS, SMEM_BYTES, st>>>(mx, mw, bias, out,
                                                          H, W, C, F, nfb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Geometry of the kernel, for the host side to check against: tile height,
// tile width, features per block, dynamic shared-memory bytes.
extern "C" void txr_conv3x3_geometry(int* out4) {
  out4[0] = TH;
  out4[1] = TW;
  out4[2] = BN;
  out4[3] = SMEM_BYTES;
}

// x: (B, H, W, C) bf16 NHWC contiguous; wp: (9, F, C) bf16 (tap = 3*di + dj,
// feature, channel); bias: (F,) f32; out: (B, H, W, F) bf16.  C and F
// multiples of 8, all pointers 16-byte aligned, B * ceil(F/128) <= 65535,
// ceil(H/16) <= 65535.  Returns a cudaError_t (0 on success).
extern "C" int txr_conv3x3_fwd(const void* x, const void* wp, const void* bias,
                               void* out, int B, int H, int W, int C, int F,
                               int relu_in, void* stream) {
  CUtensorMap mx, mw;
  {
    const uint64_t dims[4] = {static_cast<uint64_t>(C),
                              static_cast<uint64_t>(W),
                              static_cast<uint64_t>(H),
                              static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {static_cast<uint64_t>(C) * 2,
                                 static_cast<uint64_t>(W) * C * 2,
                                 static_cast<uint64_t>(H) * W * C * 2};
    const uint32_t box[4] = {CK, PW, PH, 1};
    const int rc = encode_bf16_map(&mx, x, 4, dims, strides, box);
    if (rc != 0) return rc;
  }
  {
    const uint64_t dims[3] = {static_cast<uint64_t>(C),
                              static_cast<uint64_t>(F), 9};
    const uint64_t strides[2] = {static_cast<uint64_t>(C) * 2,
                                 static_cast<uint64_t>(F) * C * 2};
    const uint32_t box[3] = {CK, BN, 1};
    const int rc = encode_bf16_map(&mw, wp, 3, dims, strides, box);
    if (rc != 0) return rc;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  return relu_in ? launch<true>(mx, mw, bp, op, B, H, W, C, F, st)
                 : launch<false>(mx, mw, bp, op, B, H, W, C, F, st);
}
