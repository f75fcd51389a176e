// K7: the whole-ensemble EM sweep on pre-gathered theta rows, hand-written
// for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_hybrid.py,
//   _em_tile_kernel_hybrid (launched by _pallas_stats_hybrid).  Same
//   contract: the theta rows of each position arrive pre-gathered as
//   streams th1, th2, th3 [B, S*K] (th_pos[b, s*K + k] = theta[s,
//   trip[b,pos], k]; the wrapper gathers them with index_select), the
//   ratings and weights per row, and p [S,K,K,K,R]; out come theta_hat
//   [S,G,K], scattered by gene id inside the kernel, p_hat = p * cross
//   [S,K,K,K,R] and loglik [S] of the pre-update state.  The TPU kernel's
//   one-hot scatter matmuls into a VMEM-resident [G, S*K] accumulator and
//   its E1/E2 selector matrices served only the TPU and are not carried
//   over: theta_hat takes global atomics, as in K3.
//
// Supported shapes: 21 <= K <= 64 (the reference runs its hybrid kernel
// only there, where p[s] does not fit one block), R <= 3, any G, S <=
// 65535, any B >= 1 (no tile multiple, no pad rows).  Exact float32 in
// both engine precision modes.
//
// Design: K3's two passes (csrc/em_large_k.cuh) with the row load taken
// from the streams (StreamRows) instead of through theta: pass 1 stages a
// 64-row tile's three stream rows per restart with reads along k, pass 2
// re-reads th1[b, s*K + k], th2 and th3 rows of its split.  The algebra,
// the scatter and the bound are K3's: ~3 K^3 multiply-adds per row and
// restart, shared-memory bound in pass 1.  The streams (3 B S K floats,
// 79 MB at B = 131,072, S = 2, K = 25) are read once by pass 1 and once
// per k-slice by pass 2, mostly from the 50 MB L2.

#include "em_large_k.cuh"

// Launch both passes on `stream`; returns cudaGetLastError() (0 on
// success).  The caller zeroes theta_hat, p_hat and ll, allocates scale
// [S, B], and sizes the shared memory and pass-2 threads from the host
// plan (ops/em_large_k.py sweep_plan, shared with K3).
extern "C" int tip_em_hybrid(
    const void* th1, const void* th2, const void* th3, const void* p,
    const void* trip, const void* rat, const void* w, void* theta_hat,
    void* p_hat, void* ll, void* scale, int S, int B, int G, int K, int R,
    int splits, int estep_smem, int cross_threads, int cross_smem,
    void* stream) {
  const large_k::StreamRows rows{(const float*)th1, (const float*)th2,
                                 (const float*)th3, S};
  return large_k::launch(rows, p, trip, rat, w, theta_hat, p_hat, ll, scale,
                         S, B, G, K, R, splits, estep_smem, cross_threads,
                         cross_smem, stream);
}
