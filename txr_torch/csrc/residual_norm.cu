// The ViT block's residual update, x' = x + gamma * branch, and where a
// LayerNorm follows at once, h = LayerNorm(x'), in one pass, for Hopper.
//
// Replaces no TPU kernel: txr leaves these passes to XLA's fusion.  It is
// added because PyTorch runs them eagerly as separate launches (the
// LayerScale product, whose (d,) operand is broadcast over the tokens, on
// its unvectorised elementwise kernel; the add; the LayerNorm), each a
// pass over the residual stream.  The function is
// txr_torch/ops/residual_norm.py:residual_norm_plain.
//
// Bound on this card: bytes.  A row is read twice (x and the branch) and
// written once or twice (x', and h with the norm), for a few flops a value.
// gamma and the norm's weight and bias are d values each, read from L1.
//
// Design.
//   * A warp owns a row.  Lane l takes the chunks l, l + 32, ... of 8
//     consecutive values (16 bytes of bf16, 32 of f32), so a warp reads 512
//     or 1024 contiguous bytes a chunk.  CHUNKS (a template parameter, 1 to
//     8) is the most chunks a lane holds, the row's chunks over 32 rounded
//     up: only a lane's last chunk can lie past the row (widths not a
//     multiple of 256), so one predicate serves (one a chunk spilled).
//     Every lane's loads of x and the branch are issued before any is
//     used.
//   * The arithmetic rounds where PyTorch's eager operators round, so x' is
//     bit-equal to the plain version: t = gamma * branch in float32,
//     rounded to bf16 where both are bf16 (the product's dtype), then
//     x' = x + t in float32, rounded to x''s dtype.
//   * The LayerNorm reads x' as rounded, in float32 registers: the mean,
//     then the biased variance of the deviations, each summed over the
//     warp by __shfl_xor_sync; h = w * (rstd * (x' - mean)) + b with
//     rstd = rsqrtf(var + eps), as PyTorch's kernel computes it (its
//     Welford sums round otherwise, so h may differ from it in the last
//     bit), rounded once to h's dtype.
//   * Types: the bf16 model's operands, all bf16; a float32 model's, all
//     float32; and bf16 autocast's (the branch bf16, the parameters
//     float32, x bf16 or float32, x' and h float32; or a bf16 model under
//     autocast, whose LayerNorm gives float32).  The dtypes argument
//     names them (bits below); the wrapper derives it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARP = 32;
constexpr int VEC = 8;                       // values a chunk
constexpr int ROWS_PER_BLOCK = 4;            // a warp a row
constexpr int THREADS = WARP * ROWS_PER_BLOCK;
constexpr int MAX_CHUNKS = 8;
constexpr int MAX_WIDTH = WARP * VEC * MAX_CHUNKS;
constexpr unsigned FULL = 0xffffffffu;

// dtypes bits: which operands are float32 (else bf16)
constexpr int X_F32 = 1, BRANCH_F32 = 2, PARAMS_F32 = 4, H_F32 = 8;

using bf16 = __nv_bfloat16;

// 8 consecutive values as loaded: one 16-byte word of bf16, two of f32
template <typename T> struct Raw;
template <> struct Raw<bf16> { uint4 w[1]; };
template <> struct Raw<float> { uint4 w[2]; };

template <typename T>
__device__ __forceinline__ Raw<T> load(const T* p) {
  Raw<T> r;
#pragma unroll
  for (int i = 0; i < int(sizeof(r.w) / sizeof(uint4)); ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

__device__ __forceinline__ void unpack(const Raw<bf16>& r, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float* v) {
  const float* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = f[i];
}

__device__ __forceinline__ void store(bf16* p, const float* v) {
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = out;
}

__device__ __forceinline__ void store(float* p, const float* v) {
  float4* o = reinterpret_cast<float4*>(p);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return std::is_same<T, bf16>::value
             ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = WARP / 2; m > 0; m /= 2) s += __shfl_xor_sync(FULL, s, m);
  return s;
}

// X, B: x's and the branch's types; P: gamma's, and the norm's weight and
// bias; H: h's; x' is float32 unless x, the branch and P are all bf16
template <typename X, typename B, typename P, typename H, int CHUNKS,
          bool NORM>
__global__ void __launch_bounds__(THREADS)
residual_norm_kernel(const X* __restrict__ x, const B* __restrict__ branch,
                     const P* __restrict__ gamma, const P* __restrict__ w,
                     const P* __restrict__ bias, void* __restrict__ out,
                     H* __restrict__ h, int rows, int width, float eps) {
  constexpr bool BF16_OUT = std::is_same<X, bf16>::value &&
                            std::is_same<B, bf16>::value &&
                            std::is_same<P, bf16>::value;
  constexpr bool BF16_T = std::is_same<B, bf16>::value &&
                          std::is_same<P, bf16>::value;
  using O = typename std::conditional<BF16_OUT, bf16, float>::type;

  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / WARP;
  if (row >= rows) return;                    // the whole warp
  const int chunks = width / VEC;
  const size_t base = static_cast<size_t>(row) * width;
  // whether a lane's i-th chunk, chunk c of the row, lies in the row
  auto held = [&](int i, int c) { return i < CHUNKS - 1 || c < chunks; };

  Raw<X> rx[CHUNKS];
  Raw<B> rb[CHUNKS];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = lane + i * WARP;
    if (held(i, c)) {
      rx[i] = load(x + base + c * VEC);
      rb[i] = load(branch + base + c * VEC);
    }
  }

  float v[CHUNKS][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = lane + i * WARP;
    if (held(i, c)) {
      float xv[VEC], bv[VEC], gv[VEC];
      unpack(rx[i], xv);
      unpack(rb[i], bv);
      unpack(load(gamma + c * VEC), gv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float t = __fmul_rn(bv[k], gv[k]);
        if (BF16_T) t = round_to<bf16>(t);
        v[i][k] = round_to<O>(__fadd_rn(xv[k], t));
        sum += v[i][k];
      }
      store(static_cast<O*>(out) + base + c * VEC, v[i]);
    }
  }
  if (!NORM) return;

  const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(width));
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if (held(i, lane + i * WARP)) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        v[i][k] = __fsub_rn(v[i][k], mean);
        sq = __fmaf_rn(v[i][k], v[i][k], sq);
      }
    }
  }
  const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(width));
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = lane + i * WARP;
    if (held(i, c)) {
      float wv[VEC], bv[VEC], y[VEC];
      unpack(load(w + c * VEC), wv);
      unpack(load(bias + c * VEC), bv);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        y[k] = __fmaf_rn(wv[k], __fmul_rn(rstd, v[i][k]), bv[k]);
      store(h + base + c * VEC, y);
    }
  }
}

template <typename X, typename B, typename P, typename H, bool NORM>
cudaError_t launch_types(const void* x, const void* branch, const void* gamma,
                         const void* w, const void* bias, void* out, void* h,
                         int rows, int width, float eps, cudaStream_t stream) {
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int chunks = width / VEC;
#define TXR_RN_LAUNCH(C)                                                   \
  case C:                                                                  \
    residual_norm_kernel<X, B, P, H, C, NORM>                              \
        <<<blocks, THREADS, 0, stream>>>(                                  \
            static_cast<const X*>(x), static_cast<const B*>(branch),       \
            static_cast<const P*>(gamma), static_cast<const P*>(w),        \
            static_cast<const P*>(bias), out, static_cast<H*>(h), rows,    \
            width, eps);                                                   \
    break
  switch ((chunks + WARP - 1) / WARP) {
    TXR_RN_LAUNCH(1); TXR_RN_LAUNCH(2); TXR_RN_LAUNCH(3); TXR_RN_LAUNCH(4);
    TXR_RN_LAUNCH(5); TXR_RN_LAUNCH(6); TXR_RN_LAUNCH(7); TXR_RN_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef TXR_RN_LAUNCH
  return cudaGetLastError();
}

template <bool NORM>
cudaError_t launch(const void* x, const void* branch, const void* gamma,
                   const void* w, const void* bias, void* out, void* h,
                   int rows, int width, int dtypes, float eps,
                   cudaStream_t stream) {
#define TXR_RN_TYPES(X, B, P, H)                                          \
  return launch_types<X, B, P, H, NORM>(x, branch, gamma, w, bias, out, h, \
                                        rows, width, eps, stream)
  // without the norm h is not written: its type is taken as x''s
  switch (NORM || dtypes == 0 ? dtypes : dtypes | H_F32) {
    case 0: TXR_RN_TYPES(bf16, bf16, bf16, bf16);
    case X_F32 | BRANCH_F32 | PARAMS_F32 | H_F32:
      TXR_RN_TYPES(float, float, float, float);
    case PARAMS_F32 | H_F32: TXR_RN_TYPES(bf16, bf16, float, float);
    case X_F32 | PARAMS_F32 | H_F32: TXR_RN_TYPES(float, bf16, float, float);
    case H_F32:
      if constexpr (NORM) TXR_RN_TYPES(bf16, bf16, bf16, float);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef TXR_RN_TYPES
}

}  // namespace

// (out[4]: threads a block, rows a block, values a chunk, widest row)
extern "C" void txr_residual_norm_geometry(int* out4) {
  out4[0] = THREADS;
  out4[1] = ROWS_PER_BLOCK;
  out4[2] = VEC;
  out4[3] = MAX_WIDTH;
}

// x, branch: (rows, width) contiguous; gamma, and the norm's weight and
// bias: (width,); out: x', (rows, width), float32 unless x, branch and the
// parameters are all bf16; h: (rows, width) of the dtypes bit H_F32, or
// null with weight and bias null for x' alone.  The dtypes allowed are the
// five combinations of launch().  width a multiple of 8 up to MAX_WIDTH; every
// pointer 16-byte aligned (the wrapper checks).  Returns the launch's
// cudaError_t.
extern "C" int txr_residual_norm_fwd(const void* x, const void* branch,
                                     const void* gamma, const void* weight,
                                     const void* bias, void* out, void* h,
                                     int rows, int width, int dtypes,
                                     float eps, void* stream) {
  if (rows < 1 || width < VEC || width % VEC || width > MAX_WIDTH ||
      rows > 2147483647 - ROWS_PER_BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool norm = h != nullptr;
  if (norm != (weight != nullptr) || norm != (bias != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      norm ? launch<true>(x, branch, gamma, weight, bias, out, h, rows,
                          width, dtypes, eps, s)
           : launch<false>(x, branch, gamma, weight, bias, out, h, rows,
                           width, dtypes, eps, s);
  return static_cast<int>(err);
}
