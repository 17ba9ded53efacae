// Fused tail of the DPT output head, for Hopper.
//
// Replaces the TPU kernel txr/ops/dpt_tail.py:_tail_kernel: bilinear
// align_corners=True upsample of the conv1 activation (B, Hin, Win, C), the
// 3x3 zero-padded conv2 (C -> F) with bias and ReLU, and the 1x1 conv3
// (F -> 1) with its bias, in one pass, so that the upsampled activation
// (B, out_h, out_w, C) never reaches device memory.
//
// Bound on this card: operations.  conv2 costs 2*9*C*F flop per output
// pixel while the function moves about 2*C*Hin*Win/(out_h*out_w) + 2 bytes
// per pixel, which at C = 128, F = 32 is above the bf16 ridge; the unfused
// form is bound by the bytes of the upsampled activation instead, and
// keeping that tensor on chip is what this kernel is for.
//
// Design: a block owns a tile of TH x 32 output pixels, one warp per tile
// row.  It first copies the repacked conv2 kernel (9, F, C) into shared
// memory, then builds the (TH+2) x 34 halo patch of the UPSAMPLED image in
// shared memory by direct four-tap lerps from the input (every ratio, up or
// down, is the same code: there is no row window that a ratio could
// outgrow).  Patch positions outside [0,out_h) x [0,out_w) are zero, which
// is conv2's padding: it applies at the border of the upsampled image and
// is not a clamp.  conv2 is then nine shifted (32 x C) @ (C x F) products
// per warp out of shared memory on mma.sync.m16n8k16 bf16 with f32
// accumulation, and bias, ReLU, the F-wide dot with w3 and b3 finish in
// registers.  Rows of both shared arrays are padded by 8 elements so the
// fragment loads are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 32;        // conv2 output features (head hidden width)
constexpr int TW = 32;       // tile width in output pixels (two m16 tiles)
constexpr int PW = TW + 2;   // patch width with the conv halo
constexpr int MAX_SMEM = 227 * 1024;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__global__ void dpt_tail_kernel(const bf16* __restrict__ x,
                                const bf16* __restrict__ w2t,
                                const float* __restrict__ b2,
                                const float* __restrict__ w3,
                                const float* __restrict__ b3,
                                bf16* __restrict__ out, int Hin, int Win,
                                int C, int out_h, int out_w, int TH,
                                float scale_h, float scale_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int CP = C + 8;                         // padded channel pitch
  bf16* sW = reinterpret_cast<bf16*>(smem_raw);  // 9*F rows x CP
  bf16* sP = sW + 9 * F * CP;                   // (TH+2)*PW pixels x CP

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int chunks = C >> 3;  // 16-byte chunks per pixel

  // conv2 kernel -> shared memory
  for (int u = tid; u < 9 * F * chunks; u += nthreads) {
    const int row = u / chunks;
    const int ch = u - row * chunks;
    const uint4 v =
        *reinterpret_cast<const uint4*>(w2t + static_cast<int64_t>(row) * C +
                                        ch * 8);
    *reinterpret_cast<uint4*>(sW + row * CP + ch * 8) = v;
  }

  // upsampled halo patch -> shared memory
  const bf16* xb = x + static_cast<int64_t>(b) * Hin * Win * C;
  const int npix = (TH + 2) * PW;
  for (int u = tid; u < npix * chunks; u += nthreads) {
    const int p = u / chunks;
    const int ch = u - p * chunks;
    const int prow = p / PW;
    const int pcol = p - prow * PW;
    const int oy = ty0 - 1 + prow;
    const int ox = tx0 - 1 + pcol;
    uint4 res = make_uint4(0u, 0u, 0u, 0u);
    if (oy >= 0 && oy < out_h && ox >= 0 && ox < out_w) {
      const float sy = oy * scale_h;
      const float sx = ox * scale_w;
      int y0 = static_cast<int>(floorf(sy));
      int x0 = static_cast<int>(floorf(sx));
      const float fy = sy - static_cast<float>(y0);
      const float fx = sx - static_cast<float>(x0);
      y0 = min(max(y0, 0), Hin - 1);
      x0 = min(max(x0, 0), Win - 1);
      const int y1 = min(y0 + 1, Hin - 1);
      const int x1 = min(x0 + 1, Win - 1);
      const bf16* r0 = xb + static_cast<int64_t>(y0) * Win * C + ch * 8;
      const bf16* r1 = xb + static_cast<int64_t>(y1) * Win * C + ch * 8;
      float v00[8], v01[8], v10[8], v11[8];
      unpack8(*reinterpret_cast<const uint4*>(r0 + x0 * C), v00);
      unpack8(*reinterpret_cast<const uint4*>(r0 + x1 * C), v01);
      unpack8(*reinterpret_cast<const uint4*>(r1 + x0 * C), v10);
      unpack8(*reinterpret_cast<const uint4*>(r1 + x1 * C), v11);
      const float wy0 = 1.f - fy, wx0 = 1.f - fx;
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = wy0 * (wx0 * v00[2 * i] + fx * v01[2 * i]) +
                        fy * (wx0 * v10[2 * i] + fx * v11[2 * i]);
        const float c = wy0 * (wx0 * v00[2 * i + 1] + fx * v01[2 * i + 1]) +
                        fy * (wx0 * v10[2 * i + 1] + fx * v11[2 * i + 1]);
        q[i] = __floats2bfloat162_rn(a, c);
      }
    }
    *reinterpret_cast<uint4*>(sP + p * CP + ch * 8) = res;
  }
  __syncthreads();

  // conv2 as nine shifted products; warp `warp` owns tile row `warp`
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

  const int ksteps = C >> 4;
  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3;
    const int dj = tap - di * 3;
    const bf16* arow = sP + ((warp + di) * PW + dj + g) * CP + t * 2;
    const bf16* wrow = sW + (tap * F + g) * CP + t * 2;
    for (int kc = 0; kc < ksteps; ++kc) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ap = arow + mt * 16 * CP + kc * 16;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * CP);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * CP + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* wp = wrow + nt * 8 * CP + kc * 16;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wp + 8);
        mma_bf16(acc[0][nt], a[0], b0, b1);
        mma_bf16(acc[1][nt], a[1], b0, b1);
      }
    }
  }

  // bias, ReLU, conv3, + b3
  float bias[4][2], wv[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bias[nt][0] = b2[nt * 8 + t * 2];
    bias[nt][1] = b2[nt * 8 + t * 2 + 1];
    wv[nt][0] = w3[nt * 8 + t * 2];
    wv[nt][1] = w3[nt * 8 + t * 2 + 1];
  }
  const float bias3 = b3[0];
  const int oy = ty0 + warp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      r0 += fmaxf(acc[mt][nt][0] + bias[nt][0], 0.f) * wv[nt][0] +
            fmaxf(acc[mt][nt][1] + bias[nt][1], 0.f) * wv[nt][1];
      r1 += fmaxf(acc[mt][nt][2] + bias[nt][0], 0.f) * wv[nt][0] +
            fmaxf(acc[mt][nt][3] + bias[nt][1], 0.f) * wv[nt][1];
    }
    r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
    r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
    if (t == 0 && oy < out_h) {
      bf16* orow = out + (static_cast<int64_t>(b) * out_h + oy) * out_w;
      const int ox0 = tx0 + mt * 16 + g;
      if (ox0 < out_w) orow[ox0] = __float2bfloat16_rn(r0 + bias3);
      if (ox0 + 8 < out_w) orow[ox0 + 8] = __float2bfloat16_rn(r1 + bias3);
    }
  }
}

}  // namespace

// x: (B, Hin, Win, C) bf16 NHWC contiguous, C a multiple of 16;
// w2t: (3, 3, 32, C) bf16 (tap, feature, channel); b2, w3: (32,) f32;
// b3: (1,) f32; out: (B, out_h, out_w) bf16.  All pointers 16-byte aligned.
// Returns the launch's cudaError_t (0 on success); cudaErrorInvalidValue
// when no tile height fits the shared memory of a block.
extern "C" int txr_dpt_tail_fwd(const void* x, const void* w2t, const void* b2,
                                const void* w3, const void* b3, void* out,
                                int B, int Hin, int Win, int C, int out_h,
                                int out_w, void* stream) {
  const int CP = C + 8;
  int TH = 8;
  size_t smem = 0;
  for (; TH >= 1; TH >>= 1) {
    smem = static_cast<size_t>(9 * F + (TH + 2) * PW) * CP * sizeof(bf16);
    if (smem <= static_cast<size_t>(MAX_SMEM)) break;
  }
  if (TH < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dpt_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_h =
      out_h > 1 ? static_cast<float>(Hin - 1) / static_cast<float>(out_h - 1)
                : 0.f;
  const float scale_w =
      out_w > 1 ? static_cast<float>(Win - 1) / static_cast<float>(out_w - 1)
                : 0.f;
  dim3 grid((out_w + TW - 1) / TW, (out_h + TH - 1) / TH, B);
  dpt_tail_kernel<<<grid, TH * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w2t),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<bf16*>(out), Hin, Win, C,
      out_h, out_w, TH, scale_h, scale_w);
  return static_cast<int>(cudaGetLastError());
}
