// Softmax attention for Hopper, straight off the fused qkv projection or
// off separate (B, H, S, D) operands.
//
// Replaces the TPU kernels txr/ops/attention.py:_fused_kernel_1pass (full
// keys) and :_fused_kernel (kv_len < S): out = softmax(q k^T / sqrt(D)) v
// with q, k, v read in place from the (B, S, 3*H*D) component-major
// projection and the result written as (B, S, H*D); and, through the second
// entry point, txr/ops/attention.py:_flash_kernel: the same function on q,
// k, v of shape (B, H, S, D).  One kernel serves both: it addresses each
// operand by a base pointer and three strides (batch, head, row), so the
// (B, H, S, D) operands may be views of any layout whose rows of D elements
// are contiguous, such as the slices a ViT takes from its fused projection,
// and need no copy.
//
// Bound on this card: operations.  4*B*H*S^2*D flop per launch against
// roughly 12*B*S*H*D bytes puts the work far above the bf16 ridge, so the
// tensor cores are the limit and device-memory traffic is not.
//
// Design: a (S x S) f32 score row does not fit registers or shared memory,
// so key tiles stream through an online softmax (running row max and row
// sum in f32, the accumulator rescaled when the max moves).  One block owns
// 128 query rows of one (batch, head): eight warps, sixteen rows each, the
// q fragments held in registers for the whole pass.  K and V tiles of 64
// keys are double buffered in shared memory with cp.async, so the loads of
// tile j+1 overlap the products of tile j.  Both products are
// mma.sync.m16n8k16 bf16 with f32 accumulation; the probabilities are
// rounded to bf16 only as the A operand of the P.V product, and the score
// accumulators are reused as that operand without a trip through memory.
// S = 2443 is a multiple of no tile, so the ragged last tile is masked
// against kv_len (rows past it are zero filled on load and their scores set
// to a large negative value); there is no padding of the sequence.
// wgmma, TMA and a persistent schedule are left for a later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dimension (every ViT preset)
constexpr int BM = 128;        // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int LDS = D + 8;     // shared-memory row pitch in elements (144 B):
                               // makes fragment loads and ldmatrix conflict free
constexpr int NTHREADS = (BM / 16) * 32;
constexpr float NEG_BIG = -1.0e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // src_bytes < 16 zero-fills the remainder of the 16-byte destination.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem_row) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies `rows` rows of D elements (global pitch `ld` elements) into shared
// memory with pitch LDS; rows at or past `limit` are zero filled.
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* gmem,
                                          int64_t ld, int row0, int limit,
                                          int rows) {
  for (int c = threadIdx.x; c < rows * (D / 8); c += NTHREADS) {
    const int r = c >> 3;
    const int ch = c & 7;
    const int gr = row0 + r;
    const bool ok = gr < limit;
    const bf16* src = gmem + static_cast<int64_t>(ok ? gr : 0) * ld + ch * 8;
    cp_async16(smem + r * LDS + ch * 8, src, ok ? 16 : 0);
  }
}

// Element strides of one operand: batch, head, row (of D contiguous values).
struct Strides {
  int64_t b, h, r;
};

__global__ void __launch_bounds__(NTHREADS, 2)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     Strides sq, Strides sk, Strides sv, Strides so, int S,
                     int kv_len, float scale_log2e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BM x LDS
  bf16* sK = sQ + BM * LDS;                      // 2 x BN x LDS
  bf16* sV = sK + 2 * BN * LDS;                  // 2 x BN x LDS

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const bf16* gQ = q + b * sq.b + h * sq.h;
  const bf16* gK = k + b * sk.b + h * sk.h;
  const bf16* gV = v + b * sv.b + h * sv.h;
  const int ntiles = (kv_len + BN - 1) / BN;

  load_tile(sQ, gQ, sq.r, q0, S, BM);
  load_tile(sK, gK, sk.r, 0, kv_len, BN);
  load_tile(sV, gV, sv.r, 0, kv_len, BN);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row of the fragment this thread holds
  const int t = lane & 3;   // column pair of the fragment

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  uint32_t qf[4][4];

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      load_tile(sK + (buf ^ 1) * BN * LDS, gK, sk.r, (j + 1) * BN, kv_len,
                BN);
      load_tile(sV + (buf ^ 1) * BN * LDS, gV, sv.r, (j + 1) * BN, kv_len,
                BN);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile j (and q) landed
    __syncthreads();

    if (j == 0) {
      const bf16* qr = sQ + (warp * 16 + g) * LDS + t * 2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(qr + kk * 16);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * LDS + kk * 16);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8);
        qf[kk][3] =
            *reinterpret_cast<const uint32_t*>(qr + 8 * LDS + kk * 16 + 8);
      }
    }

    const bf16* kb = sK + buf * BN * LDS;
    const bf16* vb = sV + buf * BN * LDS;

    // scores: 16 query rows x 64 keys per warp, f32
    float s[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      s[ni][0] = s[ni][1] = s[ni][2] = s[ni][3] = 0.f;
      const bf16* kr = kb + (ni * 8 + g) * LDS + t * 2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[ni], qf[kk], b0, b1);
      }
    }

    // scale into the exp2 domain, mask the ragged edge, row max
    const int key0 = j * BN + t * 2;
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int key = key0 + ni * 8;
      const bool ok0 = key < kv_len;
      const bool ok1 = key + 1 < kv_len;
      s[ni][0] = ok0 ? s[ni][0] * scale_log2e : NEG_BIG;
      s[ni][1] = ok1 ? s[ni][1] * scale_log2e : NEG_BIG;
      s[ni][2] = ok0 ? s[ni][2] * scale_log2e : NEG_BIG;
      s[ni][3] = ok1 ? s[ni][3] * scale_log2e : NEG_BIG;
      mx0 = fmaxf(mx0, fmaxf(s[ni][0], s[ni][1]));
      mx1 = fmaxf(mx1, fmaxf(s[ni][2], s[ni][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      s[ni][0] = exp2f(s[ni][0] - mn0);
      s[ni][1] = exp2f(s[ni][1] - mn0);
      s[ni][2] = exp2f(s[ni][2] - mn1);
      s[ni][3] = exp2f(s[ni][3] - mn1);
      rs0 += s[ni][0] + s[ni][1];
      rs1 += s[ni][2] + s[ni][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      o[ni][0] *= alpha0;
      o[ni][1] *= alpha0;
      o[ni][2] *= alpha1;
      o[ni][3] *= alpha1;
    }

    // o += P V : the score accumulators of two adjacent key octets are the
    // A fragment of one 16-key step; V comes transposed through ldmatrix.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = vb + (kk * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t r0, r1, r2, r3;
        ldmatrix_x4_trans(r0, r1, r2, r3, vr + dn * 16);
        mma_bf16(o[2 * dn], pa, r0, r1);
        mma_bf16(o[2 * dn + 1], pa, r2, r3);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);

  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const int64_t ldo = so.r;
  bf16* ob = out + b * so.b + h * so.h + t * 2;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    if (row0 < S) {
      *reinterpret_cast<uint32_t*>(ob + row0 * ldo + ni * 8) =
          pack_bf16(o[ni][0] * inv0, o[ni][1] * inv0);
    }
    if (row1 < S) {
      *reinterpret_cast<uint32_t*>(ob + row1 * ldo + ni * 8) =
          pack_bf16(o[ni][2] * inv1, o[ni][3] * inv1);
    }
  }
}

int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int S, int H, int kv_len,
           float scale, void* stream) {
  const size_t smem = static_cast<size_t>(BM + 4 * BN) * LDS * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BM - 1) / BM, H, B);
  attention_fwd_kernel<<<grid, NTHREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, sq, sk, sv, so, S, kv_len, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, S, 3*H*64) bf16 contiguous, 16-byte aligned; out: (B, S, H*64).
// 1 <= kv_len <= S.  Returns the launch's cudaError_t (0 on success).
extern "C" int txr_attention_fwd(const void* qkv, void* out, int B, int S,
                                 int H, int kv_len, float scale,
                                 void* stream) {
  const int64_t ld = static_cast<int64_t>(3) * H * D;
  const Strides in = {static_cast<int64_t>(S) * ld, D, ld};
  const Strides so = {static_cast<int64_t>(S) * H * D, D,
                      static_cast<int64_t>(H) * D};
  const bf16* base = static_cast<const bf16*>(qkv);
  return launch(base, base + H * D, base + 2 * H * D, static_cast<bf16*>(out),
                in, in, in, so, B, S, H, kv_len, scale, stream);
}

// q, k, v, out: (B, H, S, 64) bf16 views.  strides: twelve element strides,
// (batch, head, row) of q, k, v and out in that order; every row of 64
// values is contiguous and 16-byte aligned.  1 <= kv_len <= S.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int txr_attention_bhsd_fwd(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int S, int kv_len, float scale,
                                      const long long* strides, void* stream) {
  Strides s[4];
  for (int i = 0; i < 4; ++i)
    s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(out), s[0],
                s[1], s[2], s[3], B, S, H, kv_len, scale, stream);
}
