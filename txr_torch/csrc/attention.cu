// Softmax attention for Hopper, straight off the fused qkv projection or
// off separate (B, H, S, D) operands.
//
// Replaces the TPU kernels txr/ops/attention.py:_fused_kernel_1pass (full
// keys) and :_fused_kernel (kv_len < S): out = softmax(q k^T / sqrt(D)) v
// with q, k, v read in place from the (B, S, 3*H*D) component-major
// projection and the result written as (B, S, H*D); and, through the second
// entry point, txr/ops/attention.py:_flash_kernel: the same function on q,
// k, v of shape (B, H, S, D).  One kernel serves both: each operand is
// described by a 4-D tensor map over (D, S, heads, B) with its own byte
// strides, so the (B, H, S, D) operands may be views of any layout whose
// rows of D elements are contiguous and whose strides are multiples of 16
// bytes, such as the slices a ViT takes from its fused projection, and need
// no copy.
//
// Bound on this card: operations.  4*B*H*S^2*D flop per launch against
// roughly 12*B*S*H*D bytes puts the work far above the bf16 ridge, so the
// tensor cores are the limit; B*H*S^2 exponentials at 16 per clock per SM
// take about as long as the products at their full rate, so the two must
// overlap.  Per 32 score elements of a warp scheduler (a quarter of an SM):
// the tensor cores take 8 clocks (256 flop an element at 1,024 a clock),
// the MUFU 8 (4 exponentials a clock), and the softmax issues about 5
// instructions an element (the scale-and-shift FFMA, the exponential, the
// row sum, the max, a share of the bf16 pack and the rescale).  At S in
// the tens of thousands the card runs at its power limit, below its top
// clock.
//
// Design.  A block owns 192 query rows of one (batch, head) and streams the
// keys in tiles of 128 through an online softmax (running row max and row
// sum in f32, the accumulator rescaled when the max moves).
//   * Both products are wgmma (f32 accumulators).  A consumer warpgroup
//     owns 64 query rows, so a K or V tile leaves shared memory once per 64
//     rows, and once loaded it serves three warpgroups.  q k^T: q (loaded
//     once) and the K tile are shared-memory operands, K-major, rows of
//     D = 64 bf16 = 128 bytes under the 128-byte swizzle (m64n128k16, four
//     depth steps).  p v: the probabilities stay in registers (the score
//     accumulators packed to bf16 are the A fragments), the V tile is the B
//     operand in its own layout (D contiguous = MN-major, the instruction's
//     transpose flag), so nothing is transposed (m64n64k16, eight depth
//     steps).
//   * Loads are off the compute warps: one thread of a producer warpgroup
//     starts TMA tile loads into a ring of three K/V stages and completion
//     arrives on mbarriers; consumers hand a stage back through an "empty"
//     mbarrier.  setmaxnreg gives the producer's registers to the
//     consumers (32 / 160: 64 score + 32 output + 32 probability registers
//     per thread and what addresses them).
//   * Products and softmax overlap inside a warpgroup and across the three:
//     step j starts the scores of tile j and, right behind them, p v of
//     tile j - 1, waits for the scores only, and runs the softmax of tile j
//     (in place in the score registers) while p v and the other
//     warpgroups' products occupy the tensor cores; the probabilities are
//     packed once p v has let go of its operand registers.  The loop's
//     first and last steps are peeled so that every step starts the same
//     two wgmma groups: when a wgmma is started under a condition the assembler cannot count
//     the groups in flight and serialises every wgmma.
//   * S = 2443 is a multiple of no tile.  The tensor map has S as a
//     dimension of its own, so a tile never runs into the next frame and
//     rows past S arrive as zeros; keys at or past kv_len are real data
//     when kv_len < S and are masked in the scores of the last tile (the
//     only one that can hold them); query rows past S are computed and not
//     stored.  There is no padding of the sequence.
//   * Exponentials.  exp2f, built without -ftz, wraps each MUFU.EX2 in a
//     fix-up for results below 2^-126 (a compare and two predicated
//     multiplies): three more instructions on about eight an element in
//     the f32max kernel's SASS.  exp2_mufu issues ex2.approx.ftz.f32
//     alone, so such a result is 0: a probability more than 2^126 below
//     its row's max, which no bf16 sum can see (a masked key's is 0 either
//     way).  The flush is this kernel's own: the build has no global -ftz,
//     so no other kernel's arithmetic moves.  Taking a share of the
//     exponentials off the MUFU onto the FMA pipe (a polynomial for 2^f)
//     was slower at every share tried on this card: without the fix-up the
//     MUFU does not set the pace.
// Arithmetic: scores in f32, exp2 with the scale folded into one fma, the
// probabilities rounded to bf16 only as the A operand, one rounding of the
// result.  No atomics: results repeat bit for bit.
//
// Score mode "boundmax" (txr/ops/attention.py:217-226, full keys only): the
// softmax shift of a row is not its running max but the Cauchy-Schwarz bound
// m = min(|q c| * max_k |k|, 60) with c = scale * log2(e), which is known
// before the first key tile.  A small kernel in front (key_norm_kernel)
// writes max_k |k| for every (batch, head); each consumer warpgroup scales
// its 64 rows of q by c in shared memory, rounds them to bf16 as txr does,
// and takes |q c| from the same pass.  Then p = 2^min(s - m, 60); the row
// sum adds the f32 p and p v takes them rounded to bf16, as in f32max; the
// running max, the two rescale exponentials and the accumulator rescale of
// every step go.  It is the template flag BOUNDMAX; the f32max
// instantiation is the code above, unchanged.  A row whose every score lies
// more than 126 below its shift keeps no probability at or above 2^-126 and
// comes out 0 (exp2f's denormals gave it a few bits): far outside the ~83
// nats of the bound within which the mode is softmax.
//
// The cached entry point (txr_attention_cached_fwd, kernel
// attention_cached_kernel; no TPU kernel: StreamVGGT is not in txr) serves
// a streaming model's frame-causal global attention: the queries of a chunk
// of frames, read from the chunk's fused projection, against a key / value
// cache whose rows are k then v of every head (row stride 2*H*D), holding
// `cached` rows of earlier frames and then the chunk's own.  A query row of
// frame f sees every cached key and the chunk's keys up to the end of frame
// f.  The block body is the same template with CAUSAL set: a block streams
// only the key tiles up to its last row's limit, so the work follows the
// mask to within a tile; frames (782 tokens in StreamVGGT) are multiples of
// no tile, so a block may span two frames and the tiles from its first
// row's limit on are masked per element against each row's own limit.  A
// kernel of its own name, so that a trace tells it from the others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_utils.cuh"

namespace {

using namespace txr;

constexpr int D = 64;            // head dimension (every ViT preset)
constexpr int NWG = 3;           // consumer warpgroups
constexpr int BM = 64 * NWG;     // query rows per block: 64 per warpgroup
constexpr int BN = 128;          // keys per tile
constexpr int NSTAGES = 3;       // K/V ring
constexpr int NTHREADS = 128 * (NWG + 1);  // consumers + the producer's
constexpr int BOX_ROWS = 64;     // rows per TMA box (8 KB)
constexpr int Q_BYTES = BM * D * 2;
constexpr int TILE_BYTES = BN * D * 2;
constexpr int SMEM_BYTES =
    1024 + Q_BYTES + 2 * NSTAGES * TILE_BYTES + 64 * 8;  // 1024: alignment
constexpr float NEG_BIG = -1.0e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the MUFU, without exp2f's fix-up: a result below 2^-126 is 0.
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int KN_THREADS = 1024;  // key-norm kernel: 128 key rows a pass
constexpr int KN_UNROLL = 8;      // passes with their loads in flight together

// kn[b * H + h] = max over the S keys of head h of |k| (f32 sums of the bf16
// values), read from the (B, S, 3*H*D) projection.  One block per (head,
// batch); eight threads share a key row of 128 bytes, one 16-byte load each.
// Bound by bytes (B*S*H*D*2 read, once); the max is exact, so the result
// repeats bit for bit.
__global__ void __launch_bounds__(KN_THREADS)
key_norm_kernel(const bf16* __restrict__ qkv, float* __restrict__ kn, int S,
                int H) {
  __shared__ float warp_max[KN_THREADS / 32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t ld = static_cast<int64_t>(3) * H * D;
  const bf16* kbase = qkv + static_cast<int64_t>(b) * S * ld + (H + h) * D;
  const int part = threadIdx.x & 7;
  const int r0 = threadIdx.x >> 3;
  float best = 0.f;
  constexpr int ROWS = KN_THREADS / 8;
  for (int s0 = 0; s0 < S; s0 += ROWS * KN_UNROLL) {
    uint4 x[KN_UNROLL];
#pragma unroll
    for (int u = 0; u < KN_UNROLL; ++u) {
      const int s = s0 + u * ROWS + r0;
      x[u] = s < S ? __ldg(reinterpret_cast<const uint4*>(kbase + s * ld) +
                           part)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < KN_UNROLL; ++u) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&x[u]);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        acc = fmaf(f.x, f.x, acc);
        acc = fmaf(f.y, f.y, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      best = fmaxf(best, acc);
    }
  }
#pragma unroll
  for (int o = 8; o < 32; o <<= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < KN_THREADS / 32; ++w) best = fmaxf(best, warp_max[w]);
    kn[b * H + h] = sqrtf(best);
  }
}

// Element strides of the output: batch, head, row (of D contiguous values).
struct Strides {
  int64_t b, h, r;
};

// The cached entry point's mask: query row r of the chunk, in frame
// r / frame_tokens, sees every cached key and the chunk's rows up to the end
// of its own frame, [0, cached + (r / frame_tokens + 1) * frame_tokens),
// never more than kv_len.  Key 0 is always seen, so the online softmax
// starts from a real max in tile 0.
struct FrameCausal {
  int cached, frame_tokens;
  __device__ __forceinline__ int limit(int row, int kv_len) const {
    return min(kv_len, cached + (row / frame_tokens + 1) * frame_tokens);
  }
};

// One block of 192 query rows from q0 of (head blockIdx.y, batch blockIdx.z),
// for both entry points.  CAUSAL (the cached entry point): the block streams
// the key tiles up to its last row's limit, and masks each row against its
// own limit from the first tile that holds a key past its first row's;
// every tile before that is whole for all of its rows.
template <bool BOUNDMAX, bool CAUSAL>
__device__ __forceinline__ void attention_block(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, bf16* __restrict__ out, Strides so, int head_q,
    int head_k, int head_v, int S, int kv_len, float scale_log2e,
    const float* __restrict__ key_norm, int q0, FrameCausal fc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;                             // NWG x 64 rows
  unsigned char* sK = sQ + Q_BYTES;                     // NSTAGES x BN rows
  unsigned char* sV = sK + NSTAGES * TILE_BYTES;        // NSTAGES x BN rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + NSTAGES * TILE_BYTES);
  uint64_t* bar_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + NSTAGES;
  uint64_t* empty = full_v + NSTAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles =
      CAUSAL ? (fc.limit(min(q0 + BM, S) - 1, kv_len) + BN - 1) / BN
             : (kv_len + BN - 1) / BN;
  const int first_masked = CAUSAL ? fc.limit(q0, kv_len) / BN : ntiles - 1;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 4 * NWG);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == NWG) {
    // ------------------------------------------------------- producer
    reg_dealloc<32>();
    if (tid == 128 * NWG) {
      mbar_arrive_expect_tx(bar_q, Q_BYTES);
      for (int r = 0; r < BM; r += BOX_ROWS)
        tma_load_4d(sQ + r * D * 2, &map_q, bar_q, 0, q0 + r, head_q + h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % NSTAGES;
        const uint32_t phase = (j / NSTAGES) & 1;
        mbar_wait(empty + st, phase ^ 1);
        mbar_arrive_expect_tx(full_k + st, TILE_BYTES);
        for (int r = 0; r < BN; r += BOX_ROWS)
          tma_load_4d(sK + st * TILE_BYTES + r * D * 2, &map_k, full_k + st, 0,
                      j * BN + r, head_k + h, b);
        mbar_arrive_expect_tx(full_v + st, TILE_BYTES);
        for (int r = 0; r < BN; r += BOX_ROWS)
          tma_load_4d(sV + st * TILE_BYTES + r * D * 2, &map_v, full_v + st, 0,
                      j * BN + r, head_v + h, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    reg_alloc<160>();
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // row of the fragment this thread holds
    const int t = lane & 3;   // column pair of the fragment

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m0 = NEG_BIG, m1 = NEG_BIG;  // running max of rows g and g + 8
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

    const uint64_t q_desc = wgmma_desc_sw128(sQ + wg * (64 * D * 2));
    mbar_wait(bar_q, 0);
    if constexpr (BOUNDMAX) {
      // Rows g and g + 8 of this warp's 16: the four threads of a row take
      // 32 of its 128 bytes each (the swizzle moves 16-byte pieces only
      // within a row, and every value of the row is treated alike).
      const float kn = key_norm[b * gridDim.y + h];
      float ss[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint4* piece = reinterpret_cast<uint4*>(
            sQ + wg * (64 * D * 2) + (warp * 16 + g + 8 * r) * (D * 2) +
            t * 32);
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint4 x = piece[c];
          uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
            const float lo = f.x * scale_log2e;
            const float hi = f.y * scale_log2e;
            acc = fmaf(lo, lo, acc);
            acc = fmaf(hi, hi, acc);
            w[e] = pack_bf16(lo, hi);
          }
          piece[c] = x;
        }
        ss[r] = acc;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 1);
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 2);
      }
      m0 = fminf(sqrtf(ss[0]) * kn, 60.f);
      m1 = fminf(sqrtf(ss[1]) * kn, 60.f);
      // the rewritten q is read by wgmma (the async proxy), by all four
      // warps of the warpgroup
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    // the keys rows g and g + 8 of this thread see (CAUSAL)
    int lim0 = kv_len, lim1 = kv_len;
    if constexpr (CAUSAL) {
      const int r0 = q0 + wg * 64 + warp * 16 + g;
      lim0 = fc.limit(r0, kv_len);
      lim1 = fc.limit(r0 + 8, kv_len);
    }

    // Software pipeline over the key tiles: step j starts the scores of
    // tile j and, right behind them, p v of tile j - 1, and runs the
    // softmax of tile j while p v of tile j - 1 (and the other warpgroups'
    // products) execute.
    float s[64];       // scores of the current tile, then its probabilities
    uint32_t p[8][4];  // probabilities of the previous tile, A fragments
    float alpha0, alpha1;

    // Online softmax of the tile in `s`, in place; MASK for the tile that
    // holds kv_len (CAUSAL: a tile that holds a row's limit).
    auto softmax = [&](auto mask, int j) {
      constexpr bool MASK = decltype(mask)::value;
      const int key0 = j * BN + t * 2;
      auto score = [&](int ni, int c) {
        if constexpr (CAUSAL) {
          if (MASK && key0 + ni * 8 + (c & 1) >= (c < 2 ? lim0 : lim1))
            return NEG_BIG;
        } else {
          if (MASK && key0 + ni * 8 + (c & 1) >= kv_len) return NEG_BIG;
        }
        return s[4 * ni + c];
      };
      if constexpr (BOUNDMAX) {
        // scores are in the exp2 domain already (q carries c); m is fixed
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int ni = 0; ni < 16; ++ni) {
          s[4 * ni] = exp2_mufu(fminf(score(ni, 0) - m0, 60.f));
          s[4 * ni + 1] = exp2_mufu(fminf(score(ni, 1) - m0, 60.f));
          s[4 * ni + 2] = exp2_mufu(fminf(score(ni, 2) - m1, 60.f));
          s[4 * ni + 3] = exp2_mufu(fminf(score(ni, 3) - m1, 60.f));
          rs0 += s[4 * ni] + s[4 * ni + 1];
          rs1 += s[4 * ni + 2] + s[4 * ni + 3];
        }
        l0 += rs0;
        l1 += rs1;
        return;
      }
      float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        mx0 = fmaxf(mx0, fmaxf(score(ni, 0), score(ni, 1)));
        mx1 = fmaxf(mx1, fmaxf(score(ni, 2), score(ni, 3)));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      // exp2 domain: p = 2^(s*c - max*c) with c = scale * log2(e)
      alpha0 = exp2_mufu((m0 - mn0) * scale_log2e);
      alpha1 = exp2_mufu((m1 - mn1) * scale_log2e);
      m0 = mn0;
      m1 = mn1;
      const float off0 = -mn0 * scale_log2e;
      const float off1 = -mn1 * scale_log2e;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        s[4 * ni] = exp2_mufu(fmaf(score(ni, 0), scale_log2e, off0));
        s[4 * ni + 1] = exp2_mufu(fmaf(score(ni, 1), scale_log2e, off0));
        s[4 * ni + 2] = exp2_mufu(fmaf(score(ni, 2), scale_log2e, off1));
        s[4 * ni + 3] = exp2_mufu(fmaf(score(ni, 3), scale_log2e, off1));
        rs0 += s[4 * ni] + s[4 * ni + 1];
        rs1 += s[4 * ni + 2] + s[4 * ni + 3];
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
    };
    auto softmax_tile = [&](int j) {
      // the only tile that can hold keys >= kv_len; CAUSAL, those that can
      // hold a row's limit
      if (CAUSAL ? j >= first_masked : j == ntiles - 1)
        softmax(std::true_type{}, j);
      else
        softmax(std::false_type{}, j);
    };
    // The probabilities, rounded to bf16 only here, as the A fragments of
    // the eight depth steps of p v (once p v of the tile before is done).
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto start_scores = [&](int st) {
      const uint64_t k_desc = wgmma_desc_sw128(sK + st * TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
      wgmma_commit();
    };
    auto start_pv = [&](int st) {
      const uint64_t v_desc = wgmma_desc_sw128(sV + st * TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_m64n64k16_rs_tb(o, p[kk], v_desc + kk * (2048 >> 4), 1);
      wgmma_commit();
    };
    auto fence_pv_operands = [&]() {
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_operands(p[kk]);
    };

    // tile 0: scores only (o is zero, so it needs no rescale)
    mbar_wait(full_k, 0);
    wgmma_fence();
    start_scores(0);
    wgmma_wait<0>();
    fence_operands(s);
    softmax_tile(0);
    pack();
    // Step j (1 <= j < ntiles): scores of tile j and p v of tile j - 1
    // started together, then the softmax of tile j under p v.
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % NSTAGES;
      const int st_prev = (j - 1) % NSTAGES;
      mbar_wait(full_k + st, (j / NSTAGES) & 1);
      mbar_wait(full_v + st_prev, ((j - 1) / NSTAGES) & 1);
      fence_pv_operands();
      wgmma_fence();
      start_scores(st);
      start_pv(st_prev);
      wgmma_wait<1>();  // the scores are there
      fence_operands(s);
      softmax_tile(j);
      wgmma_wait<0>();  // p v of the previous tile is done
      fence_pv_operands();
      if (lane == 0) mbar_arrive(empty + st_prev);
      if constexpr (!BOUNDMAX) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          o[4 * ni] *= alpha0;
          o[4 * ni + 1] *= alpha0;
          o[4 * ni + 2] *= alpha1;
          o[4 * ni + 3] *= alpha1;
        }
      }
      pack();
    }
    {  // p v of the last tile
      const int st_prev = (ntiles - 1) % NSTAGES;
      mbar_wait(full_v + st_prev, ((ntiles - 1) / NSTAGES) & 1);
      fence_pv_operands();
      wgmma_fence();
      start_pv(st_prev);
      wgmma_wait<0>();
      fence_operands(o);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);

    const int row0 = q0 + wg * 64 + warp * 16 + g;
    const int row1 = row0 + 8;
    bf16* ob = out + b * so.b + h * so.h + t * 2;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      if (row0 < S) {
        *reinterpret_cast<uint32_t*>(ob + row0 * so.r + ni * 8) =
            pack_bf16(o[4 * ni] * inv0, o[4 * ni + 1] * inv0);
      }
      if (row1 < S) {
        *reinterpret_cast<uint32_t*>(ob + row1 * so.r + ni * 8) =
            pack_bf16(o[4 * ni + 2] * inv1, o[4 * ni + 3] * inv1);
      }
    }
  }
}

template <bool BOUNDMAX>
__global__ void __launch_bounds__(NTHREADS, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     bf16* __restrict__ out, Strides so, int head_q,
                     int head_k, int head_v, int S, int kv_len,
                     float scale_log2e, const float* __restrict__ key_norm) {
  attention_block<BOUNDMAX, false>(map_q, map_k, map_v, out, so, head_q,
                                   head_k, head_v, S, kv_len, scale_log2e,
                                   key_norm, blockIdx.x * BM,
                                   FrameCausal{0, 1});
}

// The cached entry point, a kernel of its own name: q from the chunk's fused
// projection (heads 0 ... H - 1 of map_q), k and v from the layer's cache
// (heads 0 ... H - 1 and H ... 2H - 1 of map_kv, kv_len rows), under
// FrameCausal's mask.  Query blocks run heaviest first (the last frames see
// the most keys), so that the grid's tail is a light block.
__global__ void __launch_bounds__(NTHREADS, 1)
attention_cached_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_kv,
                        bf16* __restrict__ out, Strides so, int H, int S,
                        int kv_len, int cached, int frame_tokens,
                        float scale_log2e) {
  attention_block<false, true>(map_q, map_kv, map_kv, out, so, 0, 0, H, S,
                               kv_len, scale_log2e, nullptr,
                               (gridDim.x - 1 - blockIdx.x) * BM,
                               FrameCausal{cached, frame_tokens});
}

// Tensor map over one operand seen as (D, S, heads, B), innermost first,
// with a (64, 64, 1, 1) box.  Strides in elements.
int make_map(CUtensorMap* map, const void* ptr, int S, int heads, int B,
             int64_t stride_row, int64_t stride_head, int64_t stride_batch) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(stride_row) * 2,
                               static_cast<uint64_t>(stride_head) * 2,
                               static_cast<uint64_t>(stride_batch) * 2};
  const uint32_t box[4] = {D, BOX_ROWS, 1, 1};
  return encode_bf16_map(map, ptr, 4, dims, strides, box);
}

template <bool BOUNDMAX>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           bf16* out, Strides so, int head_q, int head_k, int head_v, int B,
           int S, int H, int kv_len, float scale, const float* key_norm,
           void* stream) {
  // per launch: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_kernel<BOUNDMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + BM - 1) / BM, H, B);
  attention_fwd_kernel<BOUNDMAX><<<grid, NTHREADS, SMEM_BYTES,
                                   static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, out, so, head_q, head_k, head_v, S, kv_len,
      scale * 1.4426950408889634f, key_norm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Geometry of the kernel, for the host side to check against: query rows per
// block, keys per tile, dynamic shared-memory bytes, threads per block.
extern "C" void txr_attention_geometry(int* out4) {
  out4[0] = BM;
  out4[1] = BN;
  out4[2] = SMEM_BYTES;
  out4[3] = NTHREADS;
}


// qkv: (B, S, 3*H*64) bf16 contiguous, 16-byte aligned; kn: (B, H) f32.
// Writes the largest key norm of every (batch, head), for score mode
// boundmax.  Returns a cudaError_t (0 on success).
extern "C" int txr_attention_key_norm(const void* qkv, void* kn, int B, int S,
                                      int H, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  key_norm_kernel<<<dim3(H, B), KN_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<float*>(kn), S, H);
  return static_cast<int>(cudaGetLastError());
}

// qkv: (B, S, 3*H*64) bf16 contiguous, 16-byte aligned; out: (B, S, H*64).
// 1 <= kv_len <= S.  key_norm: null for score mode f32max, or the (B, H)
// output of txr_attention_key_norm for boundmax, which needs kv_len == S.
// Returns a cudaError_t (0 on success).
extern "C" int txr_attention_fwd(const void* qkv, void* out, int B, int S,
                                 int H, int kv_len, float scale,
                                 const void* key_norm, void* stream) {
  const int64_t ld = static_cast<int64_t>(3) * H * D;
  CUtensorMap map;  // q, k and v are head ranges of one map
  const int rc = make_map(&map, qkv, S, 3 * H, B, ld, D, S * ld);
  if (rc != 0) return rc;
  const Strides so = {static_cast<int64_t>(S) * H * D, D,
                      static_cast<int64_t>(H) * D};
  if (key_norm == nullptr)
    return launch<false>(map, map, map, static_cast<bf16*>(out), so, 0, H,
                         2 * H, B, S, H, kv_len, scale, nullptr, stream);
  if (kv_len != S) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(map, map, map, static_cast<bf16*>(out), so, 0, H, 2 * H,
                      B, S, H, kv_len, scale,
                      static_cast<const float*>(key_norm), stream);
}

// q, k, v, out: (B, H, S, 64) bf16 views.  strides: twelve element strides,
// (batch, head, row) of q, k, v and out in that order; every row of 64
// values is contiguous, the bases are 16-byte aligned and the strides of q,
// k and v are non-zero multiples of 8 elements.  1 <= kv_len <= S.  Returns
// a cudaError_t (0 on success).
extern "C" int txr_attention_bhsd_fwd(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int S, int kv_len, float scale,
                                      const long long* strides, void* stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = make_map(&maps[i], ptrs[i], S, H, B, strides[3 * i + 2],
                            strides[3 * i + 1], strides[3 * i]);
    if (rc != 0) return rc;
  }
  const Strides so = {strides[9], strides[10], strides[11]};
  return launch<false>(maps[0], maps[1], maps[2], static_cast<bf16*>(out), so,
                       0, 0, 0, B, S, H, kv_len, scale, nullptr, stream);
}

// The cached entry point.  qkv: (S, 3*H*64) bf16 contiguous, 16-byte
// aligned, the chunk's fused projection (its q is read); kv: rows of 2*H*64
// bf16 (k of every head, then v), contiguous and 16-byte aligned, the
// layer's cache, of which the first kv_len rows are read; out: (S, H*64).
// Query row r attends to keys [0, min(kv_len, cached + (r / frame_tokens +
// 1) * frame_tokens)).  1 <= frame_tokens, 0 <= cached, 1 <= kv_len.
// Returns a cudaError_t (0 on success).
extern "C" int txr_attention_cached_fwd(const void* qkv, const void* kv,
                                        void* out, int S, int H, int kv_len,
                                        int cached, int frame_tokens,
                                        float scale, void* stream) {
  if (S < 1 || H < 1 || H > 65535 || kv_len < 1 || cached < 0 ||
      frame_tokens < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_kv;
  const int64_t ldq = static_cast<int64_t>(3) * H * D;
  const int64_t ldkv = static_cast<int64_t>(2) * H * D;
  int rc = make_map(&map_q, qkv, S, 3 * H, 1, ldq, D, S * ldq);
  if (rc != 0) return rc;
  rc = make_map(&map_kv, kv, kv_len, 2 * H, 1, ldkv, D, kv_len * ldkv);
  if (rc != 0) return rc;
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_cached_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides so = {static_cast<int64_t>(S) * H * D, D,
                      static_cast<int64_t>(H) * D};
  dim3 grid((S + BM - 1) / BM, H, 1);
  attention_cached_kernel<<<grid, NTHREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      map_q, map_kv, static_cast<bf16*>(out), so, H, S, kv_len, cached,
      frame_tokens, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
