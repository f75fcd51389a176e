// K9: the rating-sorted whole-ensemble EM sweep (E-step + M-accumulate)
// for the trigenic MMSBM, hand-written for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_rsorted.py,
//   _em_tile_kernel_rsorted (launched by _pallas_stats_rsorted).  Same
//   contract: rows in the order of a rating-sort plan (every plan tile of
//   tile_b rows holds one rating), the int32 [n_tiles] tile -> rating
//   table, theta [S,G,K] and p [S,K,K,K,R] in; theta_hat [S,G,K], p_hat =
//   p * cross [S,K,K,K,R] and loglik [S] of the pre-update state out.
//   Ratings come from the table; per-row ratings are never read.  The TPU
//   kernel's one-hot gather/scatter matmuls, prefetched index maps and
//   [G, S*K] accumulator served the TPU's matrix unit and are not carried.
//
// Supported shapes: 1 <= K <= 28 (the host plan, ops/em_rsorted.py
// sweep_plan, checks the shared-memory budget and refuses anything larger);
// any R (shared memory does not grow with it); any G; any S <= 65535; B a
// whole number of plan tiles, the kernel tile dividing tile_b.
//
// What bounds it on the H100: K1's work (~3 K^3 multiply-adds per row and
// restart against one rating's K^3 slice of p[s], plus placing 3 K
// marginals per row), so as for K1 at K = 10 neither the float32 rate nor
// HBM bandwidth but shared-memory traffic of the K^3 loops and the placing
// of the marginals.  What the sort buys on the card is room: a block
// holds one rating's slice of p[s] and of its cross-stats instead of all R,
// which takes K from 20 (K1) to 28 (206,368 bytes of shared memory there
// with 8-row tiles).
//
// Design: K1's (em_sweep.cu) on the register-tiled algebra of em_tile.cuh
// (80 registers, 3 blocks per SM), carved with R = 1 and every row's
// rating 0, so its in-block sort has one segment and no pad slots:
// - grid (row blocks, S): a block owns one restart s and a contiguous run
//   of rows, walked in kernel tiles of `tile` rows; a kernel tile lies in
//   one plan tile, so it has one rating, read from the table;
// - the block stages that rating's slice of p[s] (K^3 floats read with
//   stride R) and zeroes its cross-stats.  Where its run crosses into the
//   next rating class it first adds p * cross into that rating's slice of
//   its own slot of the partial buffer, then restages;
// - a tile whose table entry is out of range is skipped whole (inert);
// - as K1 (em_sweep.cu), no atomics: each block owns a slot [LD] of the
//   partial buffer part [S, blocks, LD], LD = G K + K^3 R + 1, holding its
//   private theta_hat (the tile's marginals of a gene summed in entry
//   order and added once, tip::add_marginals), its p * cross and its sum
//   w log D; csrc/block_sum.cu sums the slots in block order, so the order
//   of every sum is fixed by the rows and the host plan.
// A tile ends without a barrier after the cross-stats, as in K1; the
// block syncs before it flushes a rating's cross-stats.
// Weight-0 rows (a class's pad rows, the common-length pad tiles) are
// inert: their scale is 0 and they add nothing.  The row load and the
// p-stat flush are this file's own: em_tile.cuh's read per-row ratings and
// all R slices of p.

#include "em_tile.cuh"

namespace {

// Stage rating r's slice of p[s] (carve with R = 1: cell i = (k*K4 + l)*K4
// + m, 0 past K), zero the cross-stats and the theta buffer.  The caller
// syncs.
__device__ inline void stage_rating(const tip::Tile& t, const float* __restrict__ p_s,
                                    int r, int R) {
  const int K = t.K, K4 = t.K4;
  for (int i = threadIdx.x; i < K * K4 * K4; i += blockDim.x) {
    const int m = i % K4, l = (i / K4) % K4, k = i / (K4 * K4);
    t.p_sm[i] = (l < K && m < K) ? p_s[((size_t)(k * K + l) * K + m) * R + r] : 0.f;
    t.cross[i] = 0.f;
  }
  for (int i = threadIdx.x; i < 3 * K4 * t.NS; i += blockDim.x) t.th[i] = 0.f;
}

// Add the staged rating's p-stats p * cross into pp[..., r], the block's
// [K, K, K, R] slot (one writer per cell).  The caller syncs before the
// buffers are restaged.
__device__ inline void flush_rating(const tip::Tile& t, float* __restrict__ pp,
                                    int r, int R) {
  const int K = t.K, K4 = t.K4;
  for (int i = threadIdx.x; i < K * K4 * K4; i += blockDim.x) {
    const int m = i % K4, l = (i / K4) % K4, k = i / (K4 * K4);
    if (l < K && m < K) pp[((size_t)(k * K + l) * K + m) * R + r] += t.p_sm[i] * t.cross[i];
  }
}

// Row metadata and theta rows of the tile's n rows from row0 (as
// tip::load_rows, with every rating 0: the tile's rating is staged).  Rows
// past n and rows with an out-of-range gene id are inert.  Leaves synced.
__device__ inline void load_rows(const tip::Tile& t, const int* __restrict__ trip,
                                 const float* __restrict__ w,
                                 const float* __restrict__ th_s, int row0, int n,
                                 int G) {
  const int K = t.K, RS = t.RS;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < t.tile; i += nt) {
    const int b = row0 + i;
    int g1 = 0, g2 = 0, g3 = 0;
    bool valid = i < n;
    if (valid) {
      g1 = trip[3 * b];
      g2 = trip[3 * b + 1];
      g3 = trip[3 * b + 2];
      valid = (unsigned)g1 < (unsigned)G && (unsigned)g2 < (unsigned)G &&
              (unsigned)g3 < (unsigned)G;
    }
    t.gene[i] = valid ? g1 : 0;
    t.gene[RS + i] = valid ? g2 : 0;
    t.gene[2 * RS + i] = valid ? g3 : 0;
    t.rr[i] = 0;
    t.wv[i] = valid ? w[b] : 0.f;
  }
  __syncthreads();
  tip::sort_rows(t, n);
  tip::Walk3 it(tid, nt, K);
  for (int i = tid; i < 3 * K * n; i += nt, it.next())
    tip::th_at(t, it.pos, it.k, t.slot[it.row]) =
        th_s[(size_t)t.gene[it.pos * RS + it.row] * K + it.k];
  __syncthreads();
}

__global__ void __launch_bounds__(tip::kThreads, 3) em_rsorted_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3], rating-sorted
    const int* __restrict__ tile_r,   // [B / tile_b]
    const float* __restrict__ w,      // [B]
    float* __restrict__ part,         // [S, gridDim.x, LD], zeroed by the caller
    int B, int G, int K, int R, int tile, int tile_b, int rows_per_block) {
  const int s = blockIdx.y;
  const int K3 = K * K * K;
  extern __shared__ float smem[];
  const tip::Tile t = tip::carve(smem, K, 1, tile);

  const size_t GK = (size_t)G * K, LD = GK + (size_t)K3 * R + 1;
  float* part_b = part + ((size_t)s * gridDim.x + blockIdx.x) * LD;
  float* pp = part_b + GK;
  const float* p_s = p + (size_t)s * K3 * R;
  const float* th_s = theta + (size_t)s * G * K;
  float ll_acc = 0.f;
  int staged = -1;  // the rating whose slice of p[s] is in shared memory
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(B, row_begin + rows_per_block);

  for (int row0 = row_begin; row0 < row_end; row0 += tile) {
    const int r = tile_r[row0 / tile_b];  // the same for every thread
    if ((unsigned)r >= (unsigned)R) continue;
    if (r != staged) {
      if (staged >= 0) {
        __syncthreads();  // the last tile's cross-stats
        flush_rating(t, pp, staged, R);
        __syncthreads();
      }
      stage_rating(t, p_s, r, R);
      __syncthreads();
      staged = r;
    }
    const int n = min(tile, row_end - row0);

    load_rows(t, trip, w, th_s, row0, n, G);
    ll_acc += tip::estep(t, n);

    tip::add_marginals(t, n, part_b);
    tip::cross_acc(t, n, false);  // the next tile's first barrier covers it
  }
  __syncthreads();
  if (staged >= 0) flush_rating(t, pp, staged, R);
  tip::block_store(ll_acc, pp + (size_t)K3 * R);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The grid
// is ((B + rows_per_block - 1) / rows_per_block, S) blocks; the caller
// zeroes part (those blocks' slots) and sizes smem_bytes from the host plan
// (ops/em_rsorted.py sweep_plan, ops/em_bdr.py launch_plan).
extern "C" int tip_em_rsorted(const void* theta, const void* p, const void* trip,
                              const void* tile_r, const void* w, void* part,
                              int S, int B, int G, int K,
                              int R, int tile, int tile_b, int rows_per_block,
                              int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        em_rsorted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + rows_per_block - 1) / rows_per_block, S);
  em_rsorted_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip,
      (const int*)tile_r, (const float*)w, (float*)part, B, G, K, R, tile,
      tile_b, rows_per_block);
  return (int)cudaGetLastError();
}
