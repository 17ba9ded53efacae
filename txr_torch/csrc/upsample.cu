// Bilinear resize of an NHWC map (F.interpolate's mode="bilinear", either
// align_corners), for Hopper: the DPT fusion blocks' upsample.
//
// Replaces no TPU kernel: txr writes the resize as interpolation-matrix
// products that XLA fuses (txr/ops/resize.py), which on the TPU ride the
// matrix unit.  It is added because PyTorch's channels-last kernel
// (upsample_bilinear2d_nhwc) gives each thread one output value: four
// integer divisions to find its pixel and channel, four scalar 2-byte loads
// and one 2-byte store, so it runs out of issue slots near a tenth of the
// card's bandwidth.  The function is txr_torch/ops/upsample.py:
// upsample_bilinear_plain.
//
// Bound on this card: bytes.  Each output value is written once and each
// input value is read about once from device memory (a source row serves
// the one or two output rows beside it while it is still in L2, a source
// pixel the output pixels beside it from L1); eight flops a value.
//
// Design.
//   * A block takes a segment of one output row (n, h2): the row's two
//     source rows and their weights are computed once a thread.  The row is
//     cut into segments of about SEGMENT_CHUNKS chunks, balanced, so that a
//     narrow map still fills the card.
//   * A chunk is V consecutive channels of one output pixel: 16 bytes of
//     input (8 bf16 or 4 float32 values) where the channel count and the
//     input's address allow it, else 8, 4 or 2 bytes, down to one value for
//     a channel count that no width divides.  Each of the four taps is one
//     load of a chunk, the result one store.
//   * Thread t walks its segment's chunks t, t + THREADS, ...: the pixel
//     and chunk of its first are found by one division, the next ones by
//     adding THREADS' quotient and remainder by the chunks a pixel and one
//     carry, so the pixel's source columns and weights are computed once a
//     chunk, not once a value.
//   * The arithmetic is PyTorch's (ATen/native/cuda/UpSample.cuh,
//     area_pixel_compute_scale and area_pixel_compute_source_index; the
//     CUDA kernels' interpolation): the scale (in - 1) / (out - 1) with
//     align_corners, else in / out, in float32 on the host; the source
//     coordinate scale * dst, or scale * (dst + 0.5) - 0.5 clamped at 0;
//     the lower tap its integer part, the upper one past it unless it is
//     the last; lambda1 = src - lower, lambda0 = 1 - lambda1; the value
//     h0 * (w0 * a + w1 * b) + h1 * (w0 * c + w1 * d) in float32, rounded
//     once to the output's type.  nvcc contracts PyTorch's expression into
//     FMAs, and differently in its bf16 and float32 kernels (found on the
//     card against F.interpolate): every operation here is an explicit
//     intrinsic that takes PyTorch's contraction for the type PyTorch
//     computes in, the output's (autocast resizes in float32), so the
//     result is F.interpolate's bit for bit.  Equal sizes copy, as
//     PyTorch does.
//   * Types: bf16 in and out (the bf16 models), float32 in and out, and
//     bf16 in with float32 out (bf16 autocast, whose policy runs the resize
//     in float32 on the bf16 values).
//   * It launches on the caller's stream, allocates nothing and does not
//     synchronise, so a CUDA graph captures it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int SEGMENT_CHUNKS = 2048;         // chunks a block, about

// dtypes bits: which operands are float32 (else bf16)
constexpr int IN_F32 = 1, OUT_F32 = 2;

using bf16 = __nv_bfloat16;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// a destination index's two source taps and their weights
struct Taps {
  int lo, hi;
  float l0, l1;
};

__device__ __forceinline__ Taps taps(float scale, int dst, int in,
                                     bool align) {
  const float d = static_cast<float>(dst);
  float src;
  if (align) {
    src = __fmul_rn(scale, d);
  } else {
    src = __fmaf_rn(scale, __fadd_rn(d, 0.5f), -0.5f);
    src = src < 0.f ? 0.f : src;
  }
  const int lo = static_cast<int>(src);
  const float l1 = __fsub_rn(src, static_cast<float>(lo));
  return {lo, lo + (lo < in - 1 ? 1 : 0), __fsub_rn(1.f, l1), l1};
}

// h0 * (w0 * a + w1 * b) + h1 * (w0 * p + w1 * q) as PyTorch's kernel for
// O computes it: its float32 kernel fuses the first row's second product,
// its bf16 kernel the first
template <typename O>
__device__ __forceinline__ float interpolate(const Taps& th, const Taps& tw,
                                             float a, float b, float p,
                                             float q) {
  const float u = std::is_same<O, float>::value
                      ? __fmaf_rn(tw.l1, b, __fmul_rn(tw.l0, a))
                      : __fmaf_rn(tw.l0, a, __fmul_rn(tw.l1, b));
  const float v = __fmaf_rn(tw.l0, p, __fmul_rn(tw.l1, q));
  return __fmaf_rn(th.l0, u, __fmul_rn(th.l1, v));
}

template <typename I, typename O, int V>
__global__ void __launch_bounds__(THREADS)
upsample_kernel(const I* __restrict__ x, O* __restrict__ y, int h_in,
                int w_in, int h_out, int w_out, int chunks, int segments,
                float rh, float rw, bool align, bool copy) {
  const int row = blockIdx.x / segments;      // n * h_out + h2
  const int seg = blockIdx.x - row * segments;
  const int n = row / h_out;
  const int h2 = row - n * h_out;
  const long long row_chunks = static_cast<long long>(w_out) * chunks;
  const int end = static_cast<int>(row_chunks * (seg + 1) / segments);
  int i = static_cast<int>(row_chunks * seg / segments) + threadIdx.x;
  if (i >= end) return;

  const size_t c_in = static_cast<size_t>(chunks) * V;   // channels
  const Taps th = copy ? Taps{h2, h2, 1.f, 0.f}
                       : taps(rh, h2, h_in, align);
  const I* r0 = x + (static_cast<size_t>(n) * h_in + th.lo) * w_in * c_in;
  const I* r1 = x + (static_cast<size_t>(n) * h_in + th.hi) * w_in * c_in;
  O* out = y + static_cast<size_t>(row) * w_out * c_in;

  int w2 = i / chunks;
  int c = i - w2 * chunks;
  const int step_w = THREADS / chunks, step_c = THREADS - step_w * chunks;
  for (; i < end; i += THREADS) {
    using In = Pack<I, V>;
    using Out = Pack<O, V>;
    const size_t at = static_cast<size_t>(c) * V;
    Out o;
    if (copy) {
      const In a = *reinterpret_cast<const In*>(r0 + w2 * c_in + at);
#pragma unroll
      for (int k = 0; k < V; ++k) o.v[k] = from_float<O>(to_float(a.v[k]));
    } else {
      const Taps tw = taps(rw, w2, w_in, align);
      const In a = *reinterpret_cast<const In*>(r0 + tw.lo * c_in + at);
      const In b = *reinterpret_cast<const In*>(r0 + tw.hi * c_in + at);
      const In p = *reinterpret_cast<const In*>(r1 + tw.lo * c_in + at);
      const In q = *reinterpret_cast<const In*>(r1 + tw.hi * c_in + at);
#pragma unroll
      for (int k = 0; k < V; ++k)
        o.v[k] = from_float<O>(interpolate<O>(
            th, tw, to_float(a.v[k]), to_float(b.v[k]), to_float(p.v[k]),
            to_float(q.v[k])));
    }
    *reinterpret_cast<Out*>(out + static_cast<size_t>(i) * V) = o;
    w2 += step_w;
    c += step_c;
    if (c >= chunks) {
      c -= chunks;
      ++w2;
    }
  }
}

// PyTorch's area_pixel_compute_scale for a size given as a size
float scale(int in, int out, bool align) {
  if (align) return out > 1 ? static_cast<float>(in - 1) / (out - 1) : 0.f;
  return static_cast<float>(in) / out;
}

template <typename I, typename O>
cudaError_t launch_types(const void* x, void* y, int n, int h_in, int w_in,
                         int c, int h_out, int w_out, bool align, int vec,
                         cudaStream_t stream) {
  const int chunks = c / vec;
  const long long row_chunks = static_cast<long long>(w_out) * chunks;
  const long long segments =
      (row_chunks + SEGMENT_CHUNKS - 1) / SEGMENT_CHUNKS;
  const long long blocks = static_cast<long long>(n) * h_out * segments;
  if (sizeof(I) * vec > 16 || blocks > 2147483647LL ||
      row_chunks > 2147483647LL - THREADS)
    return cudaErrorInvalidValue;
  const bool copy = h_in == h_out && w_in == w_out;
  const float rh = scale(h_in, h_out, align), rw = scale(w_in, w_out, align);
#define TXR_UP_LAUNCH(V)                                                   \
  case V:                                                                  \
    upsample_kernel<I, O, V><<<static_cast<unsigned>(blocks), THREADS, 0,  \
                               stream>>>(                                  \
        static_cast<const I*>(x), static_cast<O*>(y), h_in, w_in, h_out,   \
        w_out, chunks, static_cast<int>(segments), rh, rw, align, copy);   \
    break
  switch (vec) {
    TXR_UP_LAUNCH(1); TXR_UP_LAUNCH(2); TXR_UP_LAUNCH(4); TXR_UP_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef TXR_UP_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// (out[4]: threads a block, chunks a segment, widest input chunk in bytes,
// most channels a chunk)
extern "C" void txr_upsample_geometry(int* out4) {
  out4[0] = THREADS;
  out4[1] = SEGMENT_CHUNKS;
  out4[2] = 16;
  out4[3] = 8;
}

// x: (n, h_in, w_in, c) contiguous (an NCHW tensor in channels_last
// memory); y: (n, h_out, w_out, c) contiguous, float32 where dtypes has
// OUT_F32, else bf16; x float32 where it has IN_F32 (then OUT_F32 too).
// vec: channels a chunk, 1, 2, 4 or 8 (8 for a bf16 input only), dividing
// c, with x and y aligned to vec values.  Returns the launch's cudaError_t.
extern "C" int txr_upsample_bilinear_fwd(const void* x, void* y, int n,
                                         int h_in, int w_in, int c,
                                         int h_out, int w_out,
                                         int align_corners, int vec,
                                         int dtypes, void* stream) {
  if (n < 1 || h_in < 1 || w_in < 1 || c < 1 || h_out < 1 || w_out < 1 ||
      vec < 1 || c % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool align = align_corners != 0;
  cudaError_t err;
  switch (dtypes) {
    case 0:
      err = launch_types<bf16, bf16>(x, y, n, h_in, w_in, c, h_out, w_out,
                                     align, vec, s);
      break;
    case OUT_F32:
      err = launch_types<bf16, float>(x, y, n, h_in, w_in, c, h_out, w_out,
                                      align, vec, s);
      break;
    case IN_F32 | OUT_F32:
      err = launch_types<float, float>(x, y, n, h_in, w_in, c, h_out,
                                       w_out, align, vec, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
