// K1: the whole-ensemble EM sweep (E-step + M-accumulate) for the trigenic
// MMSBM, hand-written for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_bdr.py,
//   _em_tile_kernel_bdr (launched by _pallas_stats_bdr).  Same contract:
//   theta_hat [S,G,K], p_hat = p * cross [S,K,K,K,R] and loglik [S] of the
//   pre-update state, equal to the batched plain sweep of ops/em.py.  The
//   TPU kernel's one-hot gather/scatter matmuls and block-diagonal operands
//   served only the TPU's matrix unit and are not carried over; this kernel
//   reads each row's rating itself, so rows need no rating sort.
//
// Supported shapes: 1 <= K <= 20 for R <= 3 (the host plan in
// ops/em_bdr.py checks the shared-memory budget and refuses anything
// larger); any G (no cap: theta rows are read from global memory); any
// S <= 65535; any B >= 1.
//
// What bounds it on the H100: per row and restart the sweep does ~3 K^3
// multiply-adds (T, A3 and the p cross-stats) against K^3 R values of
// p[s], plus 3 K scattered atomic adds into theta_hat.  At K = 10 that is
// far below the card's float32 rate and its HBM bandwidth: theta (400 KB
// at G = 1000, S = 10) and p stay L2-resident, so the limits are the
// shared-memory reads of the K^3 products and the L2 atomics of the
// theta_hat scatter (39 M a sweep at the headline shape).
//
// Design:
// - grid (row blocks, S): a block owns one restart s and a contiguous run
//   of rows, walked in tiles of `tile` rows;
// - p[s] is staged once in shared memory and the p cross-stats stay there
//   for the block's whole run, flushed once per block as p * cross with
//   atomicAdd;
// - per tile the rows are sorted by rating inside the block and T, U (for
//   A3) and the cross-stats are register-tiled products over each rating's
//   rows (csrc/em_tile.cuh, which K4, K5a and K9 share: its header gives
//   the layout; 80 registers by ptxas, 3 blocks per SM, 70,304 bytes of
//   shared memory at K = 10, R = 2);
// - theta_hat gets one atomicAdd per (row, position, k) with nonzero
//   weight, k fastest, so a warp's atomics fall on a few gene rows; loglik
//   is reduced per block, then one atomicAdd per block.
// Weight-0 rows are inert: their scale is 0 and they add nothing.

#include "em_tile.cuh"

namespace {

__global__ void __launch_bounds__(tip::kThreads, 3) em_sweep_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    const int* __restrict__ rat,      // [B]
    const float* __restrict__ w,      // [B]
    float* __restrict__ theta_hat,    // [S, G, K], zeroed by the caller
    float* __restrict__ p_hat,        // [S, K, K, K, R], zeroed by the caller
    float* __restrict__ ll,           // [S], zeroed by the caller
    int B, int G, int K, int R, int tile, int rows_per_block) {
  const int s = blockIdx.y;
  const int K3 = K * K * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ float smem[];
  const tip::Tile t = tip::carve(smem, K, R, tile);
  const int RS = t.RS;

  tip::stage_p(t, p + (size_t)s * K3 * R);
  const float* th_s = theta + (size_t)s * G * K;
  float* thh_s = theta_hat + (size_t)s * G * K;
  float ll_acc = 0.f;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(B, row_begin + rows_per_block);
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += tile) {
    const int n = min(tile, row_end - row0);

    tip::load_rows(t, trip, rat, w, th_s, row0, n, G);
    ll_acc += tip::estep(t, n);

    // theta_hat[gene_pos] += th_pos * A_pos * scale, k fastest: a warp's
    // atomics fall on a few gene rows
    tip::Walk3 it(tid, nt, K);
    for (int i = tid; i < 3 * K * n; i += nt, it.next()) {
      if (t.wv[it.row] != 0.f)
        atomicAdd(&thh_s[(size_t)t.gene[it.pos * RS + it.row] * K + it.k],
                  tip::marginal(t, it.pos, it.k, it.row));
    }
    tip::cross_acc(t, n);
  }
  tip::flush(t, p_hat + (size_t)s * K3 * R, ll_acc, ll + s);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller zeroes theta_hat, p_hat and ll and sizes smem_bytes from the
// host plan (ops/em_bdr.py sweep_plan).
extern "C" int tip_em_sweep(const void* theta, const void* p, const void* trip,
                            const void* rat, const void* w, void* theta_hat,
                            void* p_hat, void* ll, int S, int B, int G, int K,
                            int R, int tile, int rows_per_block, int threads,
                            int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        em_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + rows_per_block - 1) / rows_per_block, S);
  em_sweep_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)w, (float*)theta_hat, (float*)p_hat, (float*)ll, B, G, K,
      R, tile, rows_per_block);
  return (int)cudaGetLastError();
}
