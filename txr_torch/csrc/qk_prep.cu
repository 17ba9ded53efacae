// QK-norm and 2-D rotary embedding of Depth Anything 3's any-view layers,
// in place on the fused qkv projection, for Hopper.
//
// Replaces no TPU kernel: Depth Anything 3 is not in txr.  The function is
// txr_torch/ops/qk_prep.py:qk_prep_plain: for q and k of every token and
// head, a float32 LayerNorm over the head's 64 values (eps, and the
// module's own weight and bias, one pair for q and one for k), then
// x cos + rot(x) sin with the cos and sin of rope_tables at the token's
// position in its view, rounded once to bf16.  v is never touched.
//
// Bound on this card: bytes.  A call reads q and k once and writes them
// once, 2 * 2 * B * S * H * 64 bytes each way (about 160 MB each way at
// 16 views of 2443 tokens and 16 heads), for about 12 flop a value, far
// below the ridge.  The plain version takes some twenty launches that read
// and write q and k several times in float32.
//
// Design.  A row is one (token, q or k, head) slice of 64 bf16; a token's
// q and k rows are its first 2 * H * 64 values, one after the other.
//   * Eight threads own a row, each 8 consecutive values from one 16-byte
//     load, neighbouring threads on neighbouring addresses: a warp reads 4
//     whole rows, 512 contiguous bytes.  A block of 256 threads takes 32
//     consecutive rows (one token's q and k at 16 heads); the last block
//     clamps its surplus rows onto the last row and does not store them, so
//     every lane stays in the shuffles.
//   * LayerNorm in float32 registers, two passes: the mean, then the biased
//     variance of the deviations, each sum folded over the row's 8 lanes by
//     __shfl_xor_sync with 1, 2 and 4.  The weight and bias are read as bf16
//     straight from the module's parameters.
//   * RoPE: rope_tables turns each half's quarters (a, b) into (-b, a).  A
//     thread's 8 values lie in one quarter; the same values of the partner
//     quarter lie in lane ^ 2 of the row: one shuffle.  cos and sin are the
//     float32 (S, 64) tables the encoder built, read at the token's position
//     in its view; a warp's rows read the same 128 bytes of each, from L1.
//   * The rotation is rounded where the plain version's separate launches
//     round (x cos and rot sin each to float32, then their sum), and the
//     result once to bf16, stored at the addresses it came from.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HEAD_DIM = 64;
constexpr int LANES = 8;                    // threads a row
constexpr int VEC = HEAD_DIM / LANES;       // values a thread: 16 bytes
constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / LANES;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void unpack(const uint4& raw, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float row_sum(float s) {
  s += __shfl_xor_sync(FULL, s, 1);
  s += __shfl_xor_sync(FULL, s, 2);
  s += __shfl_xor_sync(FULL, s, 4);
  return s;
}

__global__ void __launch_bounds__(THREADS)
qk_prep_kernel(__nv_bfloat16* __restrict__ qkv,
               const float* __restrict__ cos_t,
               const float* __restrict__ sin_t,
               const __nv_bfloat16* __restrict__ qw,
               const __nv_bfloat16* __restrict__ qb,
               const __nv_bfloat16* __restrict__ kw,
               const __nv_bfloat16* __restrict__ kb,
               int rows, int seq, int heads, float eps) {
  const int lane = threadIdx.x % LANES;
  int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / LANES;
  const bool live = row < rows;
  if (!live) row = rows - 1;
  const int per_token = 2 * heads;
  const int tok = row / per_token;
  const int j = row - tok * per_token;      // q heads, then k heads
  const int pos = tok % seq;
  const bool is_k = j >= heads;

  __nv_bfloat16* p = qkv + static_cast<size_t>(tok) * 3 * heads * HEAD_DIM +
                     static_cast<size_t>(j) * HEAD_DIM + lane * VEC;
  float x[VEC], w[VEC], b[VEC], c[VEC], s[VEC];
  unpack(*reinterpret_cast<const uint4*>(p), x);
  unpack(*reinterpret_cast<const uint4*>((is_k ? kw : qw) + lane * VEC), w);
  unpack(*reinterpret_cast<const uint4*>((is_k ? kb : qb) + lane * VEC), b);
  const size_t t = static_cast<size_t>(pos) * HEAD_DIM + lane * VEC;
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 cv = *reinterpret_cast<const float4*>(cos_t + t + i);
    const float4 sv = *reinterpret_cast<const float4*>(sin_t + t + i);
    c[i] = cv.x; c[i + 1] = cv.y; c[i + 2] = cv.z; c[i + 3] = cv.w;
    s[i] = sv.x; s[i + 1] = sv.y; s[i + 2] = sv.z; s[i + 3] = sv.w;
  }

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) sum += x[i];
  const float mean = row_sum(sum) * (1.f / HEAD_DIM);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    x[i] -= mean;
    sq += x[i] * x[i];
  }
  const float rstd = rsqrtf(row_sum(sq) * (1.f / HEAD_DIM) + eps);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = w[i] * (rstd * x[i]) + b[i];

  // quarter a (lane & 2 == 0) takes -b, quarter b takes a
  const bool second = lane & 2;
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < VEC; i += 2) {
    float y[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float partner = __shfl_xor_sync(FULL, x[i + k], 2);
      const float rot = second ? partner : -partner;
      y[k] = __fadd_rn(__fmul_rn(x[i + k], c[i + k]),
                       __fmul_rn(rot, s[i + k]));
    }
    o[i / 2] = __floats2bfloat162_rn(y[0], y[1]);
  }
  if (live) *reinterpret_cast<uint4*>(p) = out;
}

}  // namespace

// (out[4]: head width, threads a block, rows a block, threads a row)
extern "C" void txr_qk_prep_geometry(int* out4) {
  out4[0] = HEAD_DIM;
  out4[1] = THREADS;
  out4[2] = ROWS_PER_BLOCK;
  out4[3] = LANES;
}

// qkv: (batch, seq, 3 * heads * 64) bf16, contiguous, updated in place;
// cos, sin: (seq, 64) f32; qw, qb, kw, kb: (64,) bf16; every pointer
// 16-byte aligned (the wrapper checks).  Returns the launch's cudaError_t.
extern "C" int txr_qk_prep_fwd(void* qkv, const void* cos_t,
                               const void* sin_t, const void* qw,
                               const void* qb, const void* kw, const void* kb,
                               int batch, int seq, int heads, float eps,
                               void* stream) {
  const long long rows = 2LL * batch * seq * heads;
  if (batch < 1 || seq < 1 || heads < 1 ||
      rows > 2147483647LL - ROWS_PER_BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((rows + ROWS_PER_BLOCK - 1) /
                                      ROWS_PER_BLOCK);
  qk_prep_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(qkv), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t),
      static_cast<const __nv_bfloat16*>(qw),
      static_cast<const __nv_bfloat16*>(qb),
      static_cast<const __nv_bfloat16*>(kw),
      static_cast<const __nv_bfloat16*>(kb), static_cast<int>(rows), seq,
      heads, eps);
  return static_cast<int>(cudaGetLastError());
}
