// K1 and K5a: the whole-ensemble EM sweep (E-step + M-accumulate) for the
// trigenic MMSBM, hand-written for Hopper (sm_90a).  One kernel, two ways
// of placing the per-row marginals.
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_bdr.py,
//   _em_tile_kernel_bdr (launched by _pallas_stats_bdr), K1: theta_hat
//   [S,G,K], p_hat = p * cross [S,K,K,K,R] and loglik [S] of the pre-update
//   state, equal to the batched plain sweep of ops/em.py.  And
//   trigenicinteractionpredictor_tpu/ops/pallas_em_bd.py, _bd_estep
//   (_em_tile_kernel_bd), with the first pallas_call of
//   trigenicinteractionpredictor_tpu/ops/pallas_em_large.py,
//   _pallas_stats_large (_em_tile_kernel_pregathered), K5a: the same p_hat
//   and loglik, and instead of theta_hat the three position-marginal
//   streams s_pos[b, (s,k)] = th_pos * A_pos * w/D [3, B, S*K], which
//   plan_scatter.cu segment-sums into theta_hat along a host plan.  The TPU
//   kernels' one-hot gather/scatter matmuls and block-diagonal operands
//   (the bd kernel computes all S^2 restart pairs of the cross matmul)
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
// p[s].  At K = 10 that is far below the card's float32 rate and its HBM
// bandwidth: theta (400 KB at G = 1000, S = 10) and p stay L2-resident, so
// the limits are the shared-memory reads of the K^3 products and placing
// the 3 K marginals of each row.
//
// Design:
// - grid (row blocks, S): a block owns one restart s and a contiguous run
//   of rows, walked in tiles of `tile` rows.  The host plan (ops/em_bdr.py
//   launch_plan) sizes the run so that the grid is one to three waves of
//   resident blocks (3 an SM); the SM count is fixed on a given card, so
//   the plan, and with it the order of every sum, is too;
// - p[s] is staged once in shared memory and the p cross-stats stay there
//   for the block's whole run; per tile the rows are sorted by rating
//   inside the block and T, U (for A3) and the cross-stats are
//   register-tiled products over each rating's rows (csrc/em_tile.cuh,
//   which K4 and K9 share: its header gives the layout);
// - every block owns a slot [LD] of the partial buffer part [S, blocks,
//   LD]: its p * cross [K,K,K,R] and its sum w log D (flush_part), and,
//   for K1, its private theta_hat [G, K] in front of them, LD = G K + K^3 R
//   + 1.  Per tile the marginals of each gene are summed over the tile's
//   entries (row, position) of that gene in entry order and added once
//   into the private theta_hat by one lane (tip::add_marginals: each gene
//   keyed to one warp, whose lanes take its (gene, k) items): no atomics;
// - csrc/block_sum.cu then sums the blocks' slots in block order into
//   theta_hat, p_hat and loglik.  So the order of every sum is fixed by the
//   rows and the plan: the same inputs give the same bits from run to run;
// - K5a (streams != null) writes the marginals as streams, k fastest, and
//   its slots hold only p * cross and w log D (LD = K^3 R + 1).  K1 takes
//   this form too, with plan_scatter.cu after it, where its private
//   theta_hats would pass the plan's memory budget (large G x K).
// Weight-0 rows are inert: their scale is 0 and they add nothing.

#include "em_tile.cuh"

namespace {

__global__ void __launch_bounds__(tip::kThreads, 3) em_sweep_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    const int* __restrict__ rat,      // [B]
    const float* __restrict__ w,      // [B]
    float* __restrict__ streams,      // [3, B, S*K], or null: theta_hat in part
    float* __restrict__ part,         // [S, gridDim.x, LD], zeroed by the caller
    int B, int G, int K, int R, int tile, int rows_per_block) {
  const int s = blockIdx.y, S = gridDim.y;
  const int K3 = K * K * K, SK = S * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ float smem[];
  const tip::Tile t = tip::carve(smem, K, R, tile);

  const size_t GK = streams ? 0 : (size_t)G * K;
  const size_t LD = GK + (size_t)K3 * R + 1;
  float* part_b = part + ((size_t)s * gridDim.x + blockIdx.x) * LD;
  tip::stage_p(t, p + (size_t)s * K3 * R);
  const float* th_s = theta + (size_t)s * G * K;
  float ll_acc = 0.f;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(B, row_begin + rows_per_block);
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += tile) {
    const int n = min(tile, row_end - row0);

    tip::load_rows(t, trip, rat, w, th_s, row0, n, G);
    ll_acc += tip::estep(t, n);

    if (streams) {
      // streams[pos, b, s*K + k]; inert rows write 0 (scale is 0).
      for (int i = tid; i < 3 * K * n; i += nt) {
        const int k = i % K, rest = i / K;
        const int row = rest % n, pos = rest / n;
        streams[((size_t)pos * B + row0 + row) * SK + s * K + k] =
            tip::marginal(t, pos, k, row);
      }
    } else {
      tip::add_marginals(t, n, part_b);
    }
    tip::cross_acc(t, n);
  }
  tip::flush_part(t, part_b + GK, ll_acc, part_b + GK + (size_t)K3 * R);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The grid
// is ((B + rows_per_block - 1) / rows_per_block, S) blocks; the caller
// zeroes part (those blocks' slots, see above) and sizes smem_bytes from the
// host plan (ops/em_bdr.py sweep_plan, launch_plan).
extern "C" int tip_em_sweep(const void* theta, const void* p, const void* trip,
                            const void* rat, const void* w, void* streams,
                            void* part, int S, int B, int G, int K, int R,
                            int tile, int rows_per_block, int threads,
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
      (const float*)w, (float*)streams, (float*)part, B, G, K, R, tile,
      rows_per_block);
  return (int)cudaGetLastError();
}
