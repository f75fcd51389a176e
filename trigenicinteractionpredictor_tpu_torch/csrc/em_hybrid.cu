// K7: the whole-ensemble EM sweep on pre-gathered theta rows, hand-written
// for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_hybrid.py,
//   _em_tile_kernel_hybrid (launched by _pallas_stats_hybrid).  Same
//   contract: the theta rows of each position arrive pre-gathered as
//   streams th1, th2, th3 [B, S*K] (th_pos[b, s*K + k] = theta[s,
//   trip[b,pos], k]; the wrapper gathers them with index_select), the
//   ratings and weights per row, and p [S,K,K,K,R]; out come theta_hat
//   [S,G,K], p_hat = p * cross
//   [S,K,K,K,R] and loglik [S] of the pre-update state.  The TPU kernel's
//   one-hot scatter matmuls into a VMEM-resident [G, S*K] accumulator and
//   its E1/E2 selector matrices served only the TPU and are not carried
//   over: theta_hat is the fixed-order segment sum (plan_scatter.cu) of
//   marginal streams, as in K3.
//
// Supported shapes: 21 <= K <= 72 (K3's plan; the reference's dispatch gives
// its hybrid kernel K = 21..64, where p[s] does not fit one block, and so
// does the port's), R <= 3, any G, S <=
// 65535, any B >= 1 (no tile multiple, no pad rows).  Exact float32 in
// both engine precision modes.
//
// Design: K3's two passes (csrc/em_large_k.cuh: rows in a stable rating
// order, register-tiled products, p staged by cp.async from a packed copy)
// with the row load taken from the streams (StreamRows) instead of through
// theta: pass 1 reads a 64-row tile's three stream rows per restart through
// the order, pass 2 copies its rows' th1, th2 and th3 stream rows by
// cp.async again for each chunk of k's.  The algebra, the fixed-order sums
// and the bound are K3's: ~3 K^3 multiply-adds per row and restart, float32 (96
// registers in pass 1, 130 in pass 2 by ptxas).  The
// streams (3 B S K floats, 79 MB at B = 131,072, S = 2, K = 25) are read
// once by pass 1 and once per k chunk by pass 2, mostly from the 50 MB L2.

#include "em_large_k.cuh"

// Launch the pack and both passes on `stream`; returns cudaGetLastError()
// (0 on success).  The caller allocates and zeroes the buffers and
// computes the rating order and its segments (order, off) as
// large_k::launch says, and sizes the blocks and shared memory from the
// host plan (ops/em_large_k.py sweep_plan, shared by K3 and K7).
extern "C" int tip_em_hybrid(
    const void* th1, const void* th2, const void* th3, const void* p,
    const void* trip, const void* w, const void* order, const void* off,
    void* pk, void* streams, void* p_part, void* ll_part, void* scale,
    void* rowinfo, int S, int B, int G, int K, int R, int KC,
    int estep_threads, int estep_smem, int nk, int splits, int vec,
    int cross_threads, int cross_smem, void* stream) {
  const large_k::StreamRows rows{(const float*)th1, (const float*)th2,
                                 (const float*)th3, S};
  return large_k::launch(rows, p, trip, w, order, off, pk, streams, p_part,
                         ll_part, scale, rowinfo, S, B, G, K, R, KC, estep_threads,
                         estep_smem, nk, splits, vec, cross_threads, cross_smem,
                         stream);
}
