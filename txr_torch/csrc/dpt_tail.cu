// Fused tail of the DPT output head, for Hopper.
//
// Replaces the TPU kernel txr/ops/dpt_tail.py:_tail_kernel: bilinear
// align_corners=True upsample of the conv1 activation (B, Hin, Win, C), the
// 3x3 zero-padded conv2 (C -> F) with bias and ReLU, and the 1x1 conv3
// (F -> N) with its bias, in one pass, so that the upsampled activation
// (B, out_h, out_w, C) never reaches device memory.  Depth Anything's heads
// have N = 1; Depth Anything 3's depth and ray branches 2 and 7.
//
// Bound on this card: operations.  conv2 costs 2*9*C*F flop per output
// pixel while the function moves about 2*C*Hin*Win/(out_h*out_w) + 2 bytes
// per pixel, which at C = 128, F = 32 is above the bf16 ridge; the unfused
// form is bound by the bytes of the upsampled activation instead, and
// keeping that tensor on chip is what this kernel is for.  With F = 32 the
// products are narrow: a wgmma m64n32k16 is 16 clocks of tensor work but
// reads 3 KB of operands (2 KB of pixels, 1 KB of weights), 24 clocks of an
// SM's 128 bytes per clock, and every patch pixel is read by nine taps; the
// lerp adds 80 bytes per 16-byte piece it makes (four taps in, one piece
// out).  So shared-memory bandwidth, not the tensor cores, is what the
// kernel runs against, and the design keeps lerp and products busy at once
// rather than in turn.
//
// Design.  A persistent grid, one block of 640 threads per SM, walks tiles
// of TH x 32 output pixels (TH = 7, or 3 when shared memory is short), x
// fastest.  The unit of work is (tile, 64-channel chunk), and three kinds of
// warps pass units along through mbarriers:
//   * The conv2 kernel, packed (9, F, C) with C contiguous, is brought in
//     ONCE per block by TMA (one box of 32 features x 64 channels per tap and
//     chunk, 128-byte swizzle) and stays: it is wgmma's B operand, K-major.
//   * One producer thread loads, per unit, the box of INPUT pixels that the
//     tile-plus-halo's taps touch (a 4-D tensor map over (C, Win, Hin, B);
//     the box size is fixed per launch from the resize ratio) into a ring of
//     one or two windows.
//   * Eleven lerp warps build the (TH+2) x 34 halo patch of the UPSAMPLED
//     image for the unit from the window: four taps per pixel out of shared
//     memory, the f32 expression wy0*(wx0*a + fx*b) + fy*(wx0*c + fx*d), one
//     rounding to bf16.  Tap indices are clamped to the image before the
//     window origin is subtracted, so the last row and column are real data
//     and never the zero fill of a box that reaches past the tensor.  Patch
//     positions outside [0,out_h) x [0,out_w) are zero, which is conv2's
//     padding: it applies at the border of the upsampled image and is not a
//     clamp.  Every ratio, up or down, is this one path; what bounds it is
//     the window's size (it must fit shared memory and a TMA box).  The
//     coordinates of a tile's patch rows and columns are worked out once
//     per tile into a small table, and a thread keeps two positions in
//     flight, so that the lerp is bound by arithmetic and not by the
//     latency of its address chain.  The patch is double buffered: the lerp
//     of unit u + 1 runs while the products of unit u do.
//   * Two consumer warpgroups run conv2 as nine shifted products per unit on
//     wgmma m64n32k16 (f32 accumulators, 16 per 64 pixels), BOTH operands
//     from shared memory.  The patch is one flat array of pixels, 34 to a
//     row, each a 128-byte row of 64 channels stored with the 128-byte
//     swizzle by hand.  A tap is then a shift by di*34 + dj pixels of the
//     whole array, so the A operand of a tap is 64 CONSECUTIVE pixels
//     starting at any pixel (the hardware swizzles by address, so a
//     descriptor may start at any 128-byte row of the array).  Outputs are
//     computed for all 34 positions of a row and the two that fall in the
//     halo are dropped (6 % of the products); 4 (or 2) tiles of 64
//     positions cover the 7 x 34 (3 x 34).  No fragment registers and no
//     waits between taps: a unit's 72 products per warpgroup are issued
//     back to back.
//   * Bias and ReLU finish in the accumulators; then, per output, the
//     F-wide dot with that output's row of w3 (read from global memory, so
//     N costs no registers) and b3: a quad of lanes reduces a pixel and one
//     lane stores it into the (B, out_h, out_w, N) output.
//   * VGGT's heads add a position embedding to the upsampled image before
//     conv2.  Through conv2's linearity that is a per-pixel term of F
//     values (conv2 of the embedding, float32, the same for every image of
//     the batch), made once by the host side; where one is given the
//     epilogue adds it to the accumulators before the bias and ReLU.
//     Without one the kernel is what it was, bit for bit.
// Channels past C inside the last chunk arrive as zeros in window and
// weights alike and are computed on.  No atomics: results repeat bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_utils.cuh"

namespace {

using namespace txr;

typedef __nv_bfloat16 bf16;

constexpr int F = 32;         // conv2 output features (head hidden width)
constexpr int TW = 32;        // tile width in output pixels
constexpr int PW = TW + 2;    // patch width with the conv halo
constexpr int CK = 64;        // channels per chunk: 128-byte rows
constexpr int NTHREADS = 640;
constexpr int NLERP = 352;    // warps 8..18; warp 19 is the producer's
constexpr int W_TILE_BYTES = F * CK * 2;       // one (tap, chunk) of conv2
constexpr int MAX_SMEM = 232448;
constexpr int MAX_BOX = 256;  // a TMA box's extent per dimension
constexpr int NBARS = 9;
constexpr int TAB_ENTRIES = 7 + 2 + PW;  // coordinate entries: rows, columns
constexpr int TAB_BYTES = 2 * TAB_ENTRIES * 16;

// Output rows of a tile whose TH x 34 positions fit `mt` product tiles of 64
// per consumer warpgroup.
__host__ __device__ constexpr int tile_height(int mt) {
  return 2 * mt * 64 / PW;
}

// A patch holds (TH + 2) x 34 pixels; the last product tile's shifted reads
// run up to 2 * 34 + 2 pixels past its own 64 (into positions whose outputs
// are dropped), and the buffer covers those too.
__host__ __device__ constexpr int patch_bytes(int mt) {
  const int written = (tile_height(mt) + 2) * PW;
  const int read = 2 * mt * 64 + 2 * PW + 2;
  return ((written > read ? written : read) * CK * 2 + 1023) / 1024 * 1024;
}

// First input index any in-range patch position of a tile starting at t0
// reads (the same f32 arithmetic on host and device).
__host__ __device__ __forceinline__ int window_origin(int t0, float scale,
                                                      int n_in) {
  const int a = t0 > 0 ? t0 - 1 : 0;
  const int lo = static_cast<int>(floorf(static_cast<float>(a) * scale));
  return lo < n_in - 1 ? lo : n_in - 1;
}

// Barrier among the lerp warps (barrier 0 is __syncthreads').
__device__ __forceinline__ void lerp_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NLERP) : "memory");
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

struct Geometry {
  int th, win_h, win_w, nwin, smem, grid, ntx, nty, nchunks, win_bytes;
};

struct Params {
  const float* b2;
  const float* w3;  // (nout, F)
  const float* b3;  // (nout,)
  const float* pos; // (out_h, out_w, F) added before the ReLU, or null
  bf16* out;        // (B, out_h, out_w, nout)
  int Hin, Win, out_h, out_w, nout;
  int nchunks, ntx, nty, ntiles;
  int win_w, win_tx, win_bytes, nwin;
  float scale_h, scale_w;
};

template <int MT>  // 64-row product tiles per consumer warpgroup
__global__ void __launch_bounds__(NTHREADS, 1)
dpt_tail_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w, const Params p) {
  constexpr int TH = tile_height(MT);
  constexpr int NPIX = (TH + 2) * PW;
  constexpr int PATCH_BYTES = patch_bytes(MT);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sW = base;                              // 9 x nchunks tiles
  unsigned char* sP = sW + 9 * p.nchunks * W_TILE_BYTES;  // 2 patches
  unsigned char* sWin = sP + 2 * PATCH_BYTES;            // nwin windows
  int4* tabs = reinterpret_cast<int4*>(sWin + p.nwin * p.win_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(tabs + 2 * TAB_ENTRIES);
  uint64_t* w_full = bars;
  uint64_t* win_full = bars + 1;
  uint64_t* win_empty = bars + 3;
  uint64_t* patch_full = bars + 5;
  uint64_t* patch_empty = bars + 7;

  const int tid = threadIdx.x;
  const int per_batch = p.ntx * p.nty;
  // tiles b, b + grid, ... are this block's; grid <= ntiles
  const int my_tiles = (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(win_full + i, 1);
      mbar_init(win_empty + i, NLERP / 32);   // lane 0 of each lerp warp
      mbar_init(patch_full + i, NLERP / 32);
      mbar_init(patch_empty + i, 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // tile -> batch, first output row, first output column
  auto decode = [&](int tile, int& b, int& ty0, int& tx0) {
    b = tile / per_batch;
    const int r = tile - b * per_batch;
    const int ty = r / p.ntx;
    ty0 = ty * TH;
    tx0 = (r - ty * p.ntx) * TW;
  };

  const int wg = tid >> 7;
  if (wg >= 2) {
    if (tid == NTHREADS - 32) {
      // ----------------------------------------------------- producer
      mbar_arrive_expect_tx(w_full, 9 * p.nchunks * W_TILE_BYTES);
      for (int tap = 0; tap < 9; ++tap)
        for (int cc = 0; cc < p.nchunks; ++cc)
          tma_load_3d(sW + (tap * p.nchunks + cc) * W_TILE_BYTES, &map_w,
                      w_full, cc * CK, 0, tap);
      int u = 0;
      for (int k = 0; k < my_tiles; ++k) {
        int b, ty0, tx0;
        decode(blockIdx.x + k * gridDim.x, b, ty0, tx0);
        const int wy = window_origin(ty0, p.scale_h, p.Hin);
        const int wx = window_origin(tx0, p.scale_w, p.Win);
        for (int cc = 0; cc < p.nchunks; ++cc, ++u) {
          const int wb = u % p.nwin;
          mbar_wait(win_empty + wb, ((u / p.nwin) & 1) ^ 1);
          mbar_arrive_expect_tx(win_full + wb, p.win_tx);
          tma_load_4d(sWin + wb * p.win_bytes, &map_x, win_full + wb, cc * CK,
                      wx, wy, b);
        }
      }
    } else if (tid < 256 + NLERP) {
      // --------------------------------------------------------- lerp
      const int lt = tid - 256;
      const int c = lt & 7;  // this thread's 16-byte piece of a pixel
      // One tap of an in-range position: its four window pieces.
      struct Taps {
        uint4 v00, v01, v10, v11;
        float fy, fx;
        bool live;
      };
      int u = 0;
      for (int k = 0; k < my_tiles; ++k) {
        int b, ty0, tx0;
        decode(blockIdx.x + k * gridDim.x, b, ty0, tx0);
        // Per tile, the coordinates of every patch row and column once:
        // {tap 0 offset, tap 1 offset, weight of tap 1, in range} relative
        // to the window, rows scaled by its width.  Two sets alternate, so
        // a thread that runs ahead never overwrites what another reads.
        int4* rtab = tabs + (k & 1) * TAB_ENTRIES;
        int4* ctab = rtab + TH + 2;
        if (lt < TH + 2 + PW) {
          const bool is_row = lt < TH + 2;
          const int o = is_row ? ty0 - 1 + lt : tx0 - 1 + (lt - (TH + 2));
          const int n_out = is_row ? p.out_h : p.out_w;
          const int n_in = is_row ? p.Hin : p.Win;
          const float scale = is_row ? p.scale_h : p.scale_w;
          const int org = window_origin(is_row ? ty0 : tx0, scale, n_in);
          const float sf = o * scale;
          int i0 = static_cast<int>(floorf(sf));
          const float f = sf - static_cast<float>(i0);
          i0 = min(max(i0, 0), n_in - 1);
          const int i1 = min(i0 + 1, n_in - 1);
          const int pitch = is_row ? p.win_w : 1;
          rtab[lt] = make_int4((i0 - org) * pitch, (i1 - org) * pitch,
                               __float_as_int(f), o >= 0 && o < n_out);
        }
        lerp_sync();
        for (int cc = 0; cc < p.nchunks; ++cc, ++u) {
          const int wb = u % p.nwin;
          const int pb = u & 1;
          mbar_wait(win_full + wb, (u / p.nwin) & 1);
          mbar_wait(patch_empty + pb, ((u >> 1) & 1) ^ 1);
          const unsigned char* win = sWin + wb * p.win_bytes;
          unsigned char* patch = sP + pb * PATCH_BYTES;
          auto fetch = [&](int px, Taps& a) {
            a.live = false;
            if (px >= NPIX) return;
            const int prow = px / PW;
            const int4 r = rtab[prow];
            const int4 q = ctab[px - prow * PW];
            a.live = r.w & q.w;
            if (!a.live) return;
            a.fy = __int_as_float(r.z);
            a.fx = __int_as_float(q.z);
            // window pixel indices; a piece sits at (c ^ (index & 7))
            const int q00 = r.x + q.x, q01 = r.x + q.y;
            const int q10 = r.y + q.x, q11 = r.y + q.y;
            a.v00 = *reinterpret_cast<const uint4*>(
                win + q00 * 128 + ((c ^ (q00 & 7)) << 4));
            a.v01 = *reinterpret_cast<const uint4*>(
                win + q01 * 128 + ((c ^ (q01 & 7)) << 4));
            a.v10 = *reinterpret_cast<const uint4*>(
                win + q10 * 128 + ((c ^ (q10 & 7)) << 4));
            a.v11 = *reinterpret_cast<const uint4*>(
                win + q11 * 128 + ((c ^ (q11 & 7)) << 4));
          };
          auto finish = [&](int px, const Taps& a) {
            if (px >= NPIX) return;
            uint4 res = make_uint4(0u, 0u, 0u, 0u);
            if (a.live) {
              float v00[8], v01[8], v10[8], v11[8];
              unpack8(a.v00, v00);
              unpack8(a.v01, v01);
              unpack8(a.v10, v10);
              unpack8(a.v11, v11);
              const float fy = a.fy, fx = a.fx;
              const float wy0 = 1.f - fy, wx0 = 1.f - fx;
              __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float lo = wy0 * (wx0 * v00[2 * i] + fx * v01[2 * i]) +
                                 fy * (wx0 * v10[2 * i] + fx * v11[2 * i]);
                const float hi =
                    wy0 * (wx0 * v00[2 * i + 1] + fx * v01[2 * i + 1]) +
                    fy * (wx0 * v10[2 * i + 1] + fx * v11[2 * i + 1]);
                q[i] = __floats2bfloat162_rn(lo, hi);
              }
            }
            *reinterpret_cast<uint4*>(patch + px * 128 +
                                      ((c ^ (px & 7)) << 4)) = res;
          };
          // two positions in flight per thread: the loads of both go out
          // before either is worked on
          constexpr int STRIDE = NLERP / 8;
          for (int px = lt >> 3; px < NPIX; px += 2 * STRIDE) {
            Taps a0, a1;
            fetch(px, a0);
            fetch(px + STRIDE, a1);
            finish(px, a0);
            finish(px + STRIDE, a1);
          }
          // wgmma reads the patch through the async proxy: every writer
          // fences its stores, then one lane speaks for the warp
          fence_proxy_async();
          __syncwarp();
          if ((lt & 31) == 0) {
            mbar_arrive(patch_full + pb);
            mbar_arrive(win_empty + wb);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;

    float bias2[8];  // features 8j + 2t, 8j + 2t + 1 for j = 0..3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bias2[2 * j] = p.b2[j * 8 + t * 2];
      bias2[2 * j + 1] = p.b2[j * 8 + t * 2 + 1];
    }

    // acc[m]: flat positions 64 * (wg * MT + m) .. + 63 of the tile's
    // TH x 34 (position f is row f / 34, column f % 34; columns 32 and 33
    // are halo and dropped); this thread holds positions 16 * warp + g and
    // + 8 of each
    float acc[MT][16];

    auto epilogue = [&](int tile) {
      int b, ty0, tx0;
      decode(tile, b, ty0, tx0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (p.pos != nullptr) {
          // the position term of this thread's two positions (zero where
          // a position's output is dropped)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = 64 * (wg * MT + m) + 16 * warp + g + 8 * h;
            const int row = f / PW;
            const int col = f - row * PW;
            const int oy = ty0 + row;
            const int ox = tx0 + col;
            const bool in = row < TH && col < TW && oy < p.out_h &&
                            ox < p.out_w;
            const float* q =
                p.pos + (static_cast<int64_t>(oy) * p.out_w + ox) * F + 2 * t;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 v = in ? *reinterpret_cast<const float2*>(q + 8 * j)
                                  : make_float2(0.f, 0.f);
              acc[m][4 * j + 2 * h] += v.x;
              acc[m][4 * j + 2 * h + 1] += v.y;
            }
          }
        }
        // conv2's bias and ReLU in place: the next unit's first product
        // overwrites the accumulators
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][4 * j + e] =
                fmaxf(acc[m][4 * j + e] + bias2[2 * j + (e & 1)], 0.f);
        for (int o = 0; o < p.nout; ++o) {
          const float* w3 = p.w3 + o * F;
          float wv[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wv[2 * j] = w3[j * 8 + t * 2];
            wv[2 * j + 1] = w3[j * 8 + t * 2 + 1];
          }
          float r[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              r[h] += acc[m][4 * j + 2 * h] * wv[2 * j] +
                      acc[m][4 * j + 2 * h + 1] * wv[2 * j + 1];
          }
          const float bias3 = p.b3[o];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            r[h] += __shfl_xor_sync(0xffffffffu, r[h], 1);
            r[h] += __shfl_xor_sync(0xffffffffu, r[h], 2);
            const int f = 64 * (wg * MT + m) + 16 * warp + g + 8 * h;
            const int row = f / PW;
            const int col = f - row * PW;
            const int oy = ty0 + row;
            const int ox = tx0 + col;
            if (t == 0 && row < TH && col < TW && oy < p.out_h &&
                ox < p.out_w)
              p.out[((static_cast<int64_t>(b) * p.out_h + oy) * p.out_w + ox) *
                        p.nout +
                    o] = __float2bfloat16_rn(r[h] + bias3);
          }
        }
      }
    };

    mbar_wait(w_full, 0);
    int u = 0;
    for (int k = 0; k < my_tiles; ++k) {
      for (int cc = 0; cc < p.nchunks; ++cc, ++u) {
        mbar_wait(patch_full + (u & 1), (u >> 1) & 1);
        const unsigned char* patch = sP + (u & 1) * PATCH_BYTES;
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_operands(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int shift = (tap / 3) * PW + tap % 3;
          const uint64_t w_desc =
              wgmma_desc_sw128(sW + (tap * p.nchunks + cc) * W_TILE_BYTES);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const uint64_t a_desc = wgmma_desc_sw128(
                patch + (64 * (wg * MT + m) + shift) * 128);
#pragma unroll
            for (int kk = 0; kk < CK / 16; ++kk)
              wgmma_m64n32k16_ss(acc[m], a_desc + 2 * kk, w_desc + 2 * kk,
                                 (cc | tap | kk) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_operands(acc[m]);
        if (lane == 0) mbar_arrive(patch_empty + (u & 1));
        if (cc == p.nchunks - 1) epilogue(blockIdx.x + k * gridDim.x);
      }
    }
  }
}

// Largest number of input rows (or columns) the taps of one tile-plus-halo
// touch, over all tiles of `tile` outputs along an axis.
int window_extent(int n_out, int n_in, int tile, float scale) {
  int best = 1;
  for (int t0 = 0; t0 < n_out; t0 += tile) {
    const int b = t0 + tile < n_out - 1 ? t0 + tile : n_out - 1;
    int hi = static_cast<int>(floorf(static_cast<float>(b) * scale));
    hi = hi < n_in - 1 ? hi : n_in - 1;
    hi = hi + 1 < n_in - 1 ? hi + 1 : n_in - 1;
    const int ext = hi - window_origin(t0, scale, n_in) + 1;
    best = ext > best ? ext : best;
  }
  return best;
}

float resize_scale(int n_in, int n_out) {
  return n_out > 1
             ? static_cast<float>(n_in - 1) / static_cast<float>(n_out - 1)
             : 0.f;
}

// Picks the tile height and the number of window buffers: the tallest tile
// and the deepest ring that fit shared memory.  False if nothing fits.
bool choose_geometry(int B, int Hin, int Win, int C, int out_h, int out_w,
                     int sms, Geometry* g) {
  if (B < 1 || Hin < 1 || Win < 1 || C < 1 || out_h < 1 || out_w < 1 ||
      sms < 1)
    return false;
  const float sh = resize_scale(Hin, out_h), sw = resize_scale(Win, out_w);
  g->nchunks = (C + CK - 1) / CK;
  g->win_w = window_extent(out_w, Win, TW, sw);
  g->ntx = (out_w + TW - 1) / TW;
  if (g->win_w > MAX_BOX) return false;
  for (int mt = 2; mt >= 1; --mt) {
    const int th = tile_height(mt);
    g->win_h = window_extent(out_h, Hin, th, sh);
    if (g->win_h > MAX_BOX) continue;
    g->win_bytes = (g->win_h * g->win_w * CK * 2 + 1023) / 1024 * 1024;
    for (int nwin = 2; nwin >= 1; --nwin) {
      const int64_t smem = 1024 + 9 * g->nchunks * W_TILE_BYTES +
                           2 * patch_bytes(mt) +
                           static_cast<int64_t>(nwin) * g->win_bytes +
                           TAB_BYTES + NBARS * 8;
      if (smem > MAX_SMEM) continue;
      g->th = th;
      g->nwin = nwin;
      g->smem = static_cast<int>(smem);
      g->nty = (out_h + th - 1) / th;
      const int64_t tiles = static_cast<int64_t>(B) * g->nty * g->ntx;
      if (tiles > 0x7fffffff / (9 * g->nchunks)) return false;
      g->grid = tiles < sms ? static_cast<int>(tiles) : sms;
      return true;
    }
  }
  return false;
}

template <int MT>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const Params& p,
           const Geometry& g, cudaStream_t st) {
  // per launch: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      dpt_tail_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dpt_tail_kernel<MT><<<g.grid, NTHREADS, g.smem, st>>>(mx, mw, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Geometry of one launch, for the host side to check against: tile height,
// tile width, window rows, window columns, window buffers, dynamic
// shared-memory bytes, grid, threads.  Returns 0, or cudaErrorInvalidValue
// when no tile fits (the window of a strong downsample is too large).
extern "C" int txr_dpt_tail_geometry(int B, int Hin, int Win, int C, int out_h,
                                     int out_w, int sms, int* out8) {
  Geometry g;
  if (!choose_geometry(B, Hin, Win, C, out_h, out_w, sms, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  out8[0] = g.th;
  out8[1] = TW;
  out8[2] = g.win_h;
  out8[3] = g.win_w;
  out8[4] = g.nwin;
  out8[5] = g.smem;
  out8[6] = g.grid;
  out8[7] = NTHREADS;
  return 0;
}

// x: (B, Hin, Win, C) bf16 NHWC contiguous, C a multiple of 16;
// w2p: (9, 32, C) bf16 (tap = 3*di + dj, feature, channel); b2: (32,) f32;
// w3: (nout, 32) f32; b3: (nout,) f32; pos: (out_h, out_w, 32) f32 added
// to conv2's output before the ReLU, or null; out: (B, out_h, out_w, nout)
// bf16.  All pointers 16-byte aligned; sms: the device's multiprocessor
// count (the persistent grid's size at most).  Returns the launch's cudaError_t (0 on
// success); cudaErrorInvalidValue when no tile fits the shared memory of a
// block or nout < 1.
extern "C" int txr_dpt_tail_fwd(const void* x, const void* w2p, const void* b2,
                                const void* w3, const void* b3,
                                const void* pos, void* out, int B, int Hin,
                                int Win, int C, int out_h, int out_w, int nout,
                                int sms, void* stream) {
  Geometry g;
  if (nout < 1 || !choose_geometry(B, Hin, Win, C, out_h, out_w, sms, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  {
    const uint64_t dims[4] = {static_cast<uint64_t>(C),
                              static_cast<uint64_t>(Win),
                              static_cast<uint64_t>(Hin),
                              static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {static_cast<uint64_t>(C) * 2,
                                 static_cast<uint64_t>(Win) * C * 2,
                                 static_cast<uint64_t>(Hin) * Win * C * 2};
    const uint32_t box[4] = {CK, static_cast<uint32_t>(g.win_w),
                             static_cast<uint32_t>(g.win_h), 1};
    const int rc = encode_bf16_map(&mx, x, 4, dims, strides, box);
    if (rc != 0) return rc;
  }
  {
    const uint64_t dims[3] = {static_cast<uint64_t>(C), F, 9};
    const uint64_t strides[2] = {static_cast<uint64_t>(C) * 2,
                                 static_cast<uint64_t>(F) * C * 2};
    const uint32_t box[3] = {CK, F, 1};
    const int rc = encode_bf16_map(&mw, w2p, 3, dims, strides, box);
    if (rc != 0) return rc;
  }
  Params p;
  p.b2 = static_cast<const float*>(b2);
  p.w3 = static_cast<const float*>(w3);
  p.b3 = static_cast<const float*>(b3);
  p.pos = static_cast<const float*>(pos);
  p.out = static_cast<bf16*>(out);
  p.Hin = Hin;
  p.Win = Win;
  p.out_h = out_h;
  p.out_w = out_w;
  p.nout = nout;
  p.nchunks = g.nchunks;
  p.ntx = g.ntx;
  p.nty = g.nty;
  p.ntiles = B * g.nty * g.ntx;
  p.win_w = g.win_w;
  p.win_tx = g.win_h * g.win_w * CK * 2;
  p.win_bytes = g.win_bytes;
  p.nwin = g.nwin;
  p.scale_h = resize_scale(Hin, out_h);
  p.scale_w = resize_scale(Win, out_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return g.th == tile_height(2) ? launch<2>(mx, mw, p, g, st)
                                : launch<1>(mx, mw, p, g, st);
}
