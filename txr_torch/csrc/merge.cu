// Merge of the voxel map's key-ordered rows with a sorted batch, for Hopper.
//
// Replaces no TPU kernel: txr sorts the map's rows and the batch's together
// with jax.lax.sort (txr/fusion/offset_map.py:165).  Added because that
// sort, of 2^26 map rows and a few million batch rows every insert, was the
// largest part of the insert, and the map's rows are already in key order
// (txr_torch/fusion/offset_map.py:OffsetVoxelMap): only the batch needs a
// sort, and this kernel merges it into the map's rows.  The function is
// txr_torch/ops/merge.py:merge_sorted_plain: the sorted int64 key and the
// permutation that a stable sort of the head rows (the map's, keys computed
// here from their int32 khi and klo_x columns) followed by the tail rows
// (the batch's, sorted keys and the sort's permutation) would give.  On an
// equal key a head row goes first; tail rows keep their order.
//
// Bound on this card: bytes.  Each head row is read once (8 bytes), each
// tail row once (16), each output row written once (16): 1.73 GB, 0.52 ms
// at 3.35 TB/s, for 2^26 map rows and an 8-frame batch of 3.83 M rows.
//
// Design (merge path).
//   * The output is cut into tiles of TILE rows.  A partition launch finds,
//     for each tile's first output row d, how many head rows precede it: a
//     binary search along the diagonal i + j = d, one thread a tile, on
//     keys read from device memory.  The splits go to a scratch of
//     tiles + 1 int32 that the wrapper allocates.
//   * A merge block takes one tile: its head and tail rows, at most TILE in
//     all, are loaded 16 bytes a thread, neighbouring threads on
//     neighbouring addresses, into one shared-memory key array (the head's
//     keys built on the way in), the tail's permutation beside it.
//   * Each thread finds its own split of ITEMS output rows by a binary
//     search in shared memory, merges them, and notes each row's source in
//     a 16-bit index.  The block then stores the tile's keys and
//     permutations two rows (16 bytes) a thread, coalesced.
//   * Most rows of an insert are head rows in long runs, so most tiles copy
//     the head with a few hundred tail rows put in between.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int PART_THREADS = 256;

// txr_torch/ops/merge.py:row_keys: (khi << 32) | (klo_x + 2^31)
__device__ __forceinline__ long long row_key(int khi, int klo) {
  const unsigned long long hi =
      static_cast<unsigned long long>(static_cast<long long>(khi)) << 32;
  return static_cast<long long>(
      hi | (static_cast<unsigned>(klo) ^ 0x80000000u));
}

// Head rows among the first d output rows: the largest i with every head
// row below i placed before tail row d - i - 1 (a head row goes first on an
// equal key).
__global__ void __launch_bounds__(PART_THREADS)
merge_partition_kernel(const int* __restrict__ khi,
                       const int* __restrict__ klo,
                       const long long* __restrict__ tkey, int nh, int nt,
                       int tiles, int* __restrict__ splits) {
  const int t = blockIdx.x * PART_THREADS + threadIdx.x;
  if (t > tiles) return;
  const int d = min(t * TILE, nh + nt);
  int lo = max(0, d - nt), hi = min(d, nh);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (row_key(khi[mid], klo[mid]) <= tkey[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  splits[t] = lo;
}

__global__ void __launch_bounds__(THREADS)
merge_tile_kernel(const int* __restrict__ khi, const int* __restrict__ klo,
                  const long long* __restrict__ tkey,
                  const long long* __restrict__ tperm, int nh_all,
                  int nt_all, const int* __restrict__ splits,
                  long long* __restrict__ out_key,
                  long long* __restrict__ out_perm) {
  __shared__ long long keys[TILE];      // the tile's head keys, then tail's
  __shared__ long long perms[TILE];     // the tile's tail permutation
  __shared__ uint16_t src[TILE];        // each output row's index in keys

  const int d0 = blockIdx.x * TILE;
  const int len = min(TILE, nh_all + nt_all - d0);
  const int i0 = splits[blockIdx.x], i1 = splits[blockIdx.x + 1];
  const int nh = i1 - i0;
  const int j0 = d0 - i0, j1 = j0 + (len - nh);
  const int nt = j1 - j0;

  // head rows [i0, i1): four of khi and four of klo a 16-byte load; the
  // ragged vectors at the column's end are read a row at a time
  for (int v = (i0 >> 2) + threadIdx.x; v < (i1 + 3) >> 2; v += THREADS) {
    int a[4], b[4];
    if (4 * v + 3 < nh_all) {
      const int4 va = reinterpret_cast<const int4*>(khi)[v];
      const int4 vb = reinterpret_cast<const int4*>(klo)[v];
      a[0] = va.x; a[1] = va.y; a[2] = va.z; a[3] = va.w;
      b[0] = vb.x; b[1] = vb.y; b[2] = vb.z; b[3] = vb.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = min(4 * v + k, nh_all - 1);
        a[k] = khi[e];
        b[k] = klo[e];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * v + k;
      if (e >= i0 && e < i1) keys[e - i0] = row_key(a[k], b[k]);
    }
  }
  // tail rows [j0, j1): two keys and two permutations a 16-byte load
  for (int v = (j0 >> 1) + threadIdx.x; v < (j1 + 1) >> 1; v += THREADS) {
    long long a[2], b[2];
    if (2 * v + 1 < nt_all) {
      const longlong2 va = reinterpret_cast<const longlong2*>(tkey)[v];
      const longlong2 vb = reinterpret_cast<const longlong2*>(tperm)[v];
      a[0] = va.x; a[1] = va.y;
      b[0] = vb.x; b[1] = vb.y;
    } else {
      a[0] = a[1] = tkey[2 * v];
      b[0] = b[1] = tperm[2 * v];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = 2 * v + k;
      if (e >= j0 && e < j1) {
        keys[nh + e - j0] = a[k];
        perms[e - j0] = b[k] + nh_all;
      }
    }
  }
  __syncthreads();

  // this thread's ITEMS output rows
  const int k0 = threadIdx.x * ITEMS;
  if (k0 < len) {
    const long long* tk = keys + nh;
    int lo = max(0, k0 - nt), hi = min(k0, nh);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] <= tk[k0 - 1 - mid])
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = k0 - lo;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (k0 + q < len) {
        const bool head = j >= nt || (i < nh && keys[i] <= tk[j]);
        src[k0 + q] = static_cast<uint16_t>(head ? i++ : nh + j++);
      }
    }
  }
  __syncthreads();

  // store two rows a thread: keys from shared memory, a head row's
  // permutation its own index
  for (int p = 2 * threadIdx.x; p < len; p += 2 * THREADS) {
    long long k[2], m[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int s = src[min(p + q, len - 1)];
      k[q] = keys[s];
      m[q] = s < nh ? static_cast<long long>(i0 + s) : perms[s - nh];
    }
    if (p + 1 < len) {
      reinterpret_cast<longlong2*>(out_key + d0)[p >> 1] =
          make_longlong2(k[0], k[1]);
      reinterpret_cast<longlong2*>(out_perm + d0)[p >> 1] =
          make_longlong2(m[0], m[1]);
    } else {
      out_key[d0 + p] = k[0];
      out_perm[d0 + p] = m[0];
    }
  }
}

}  // namespace

// (out[4]: output rows a tile, threads a merge block, rows a thread,
// threads a partition block)
extern "C" void txr_merge_geometry(int* out4) {
  out4[0] = TILE;
  out4[1] = THREADS;
  out4[2] = ITEMS;
  out4[3] = PART_THREADS;
}

// khi, klo: (n_head,) int32 in key order; tkey, tperm: (n_tail,) int64,
// the tail's sorted keys and its sort's permutation; out_key, out_perm:
// (n_head + n_tail,) int64; splits: (tiles + 1,) int32 scratch.  Every
// pointer 16-byte aligned (the wrapper checks).  Returns the launches'
// cudaError_t.
extern "C" int txr_merge_sorted_fwd(const void* khi, const void* klo,
                                    const void* tkey, const void* tperm,
                                    long long n_head, long long n_tail,
                                    void* out_key, void* out_perm,
                                    void* splits, void* stream) {
  const long long n = n_head + n_tail;
  if (n_head < 0 || n_tail < 0 || n < 1 || n > 2147483647LL - TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>((n + TILE - 1) / TILE);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  merge_partition_kernel<<<(tiles + PART_THREADS) / PART_THREADS,
                           PART_THREADS, 0, s>>>(
      static_cast<const int*>(khi), static_cast<const int*>(klo),
      static_cast<const long long*>(tkey), static_cast<int>(n_head),
      static_cast<int>(n_tail), tiles, static_cast<int*>(splits));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_tile_kernel<<<tiles, THREADS, 0, s>>>(
      static_cast<const int*>(khi), static_cast<const int*>(klo),
      static_cast<const long long*>(tkey),
      static_cast<const long long*>(tperm), static_cast<int>(n_head),
      static_cast<int>(n_tail), static_cast<const int*>(splits),
      static_cast<long long*>(out_key), static_cast<long long*>(out_perm));
  return static_cast<int>(cudaGetLastError());
}
