// K3: the whole-ensemble EM sweep for large K (21 <= K <= 72), hand-written
// for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em.py,
//   _em_tile_kernel (launched by _pallas_stats) in its ensemble, grouped and
//   single-restart forms.  Same contract as K1 (csrc/em_sweep.cu):
//   theta_hat [S,G,K], p_hat = p * cross [S,K,K,K,R] and loglik [S] of the
//   pre-update state, equal to the batched plain sweep of ops/em.py.  Rows
//   arrive unsorted and each row's rating is read per row.  The TPU kernel's
//   one-hot gather/scatter matmuls and its E1/E2 selector matrices served
//   only the TPU's matrix unit and are not carried over.
//
// Supported shapes: 21 <= K <= 72 (the host plan in ops/em_large_k.py),
// R <= 3, any G (theta rows are read from global memory), S <= 65535, B >= 1.
//
// Why not K1: K1 stages all of p[s] and its cross-stats in one block's
// shared memory, 2 R K^3 floats: 250 KB at K = 25, 2 MB at K = 50.  Here no
// block holds all of p[s], and the sweep runs as two passes.
//
// The two passes (an E-step pass over k-slices of p and a cross-stat pass
// that owns slices of p_hat), what bounds them on the H100 and how inert
// rows are handled are described in csrc/em_large_k.cuh, which K7
// (csrc/em_hybrid.cu) shares.  Here a row's theta values are read through
// its gene ids from theta (GatherRows); theta (G S K floats) and p stay
// L2-resident.

#include "em_large_k.cuh"

// Launch both passes on `stream`; returns cudaGetLastError() (0 on
// success).  The caller zeroes theta_hat, p_hat and ll, allocates scale
// [S, B], and sizes the shared memory and pass-2 threads from the host
// plan (ops/em_large_k.py sweep_plan).
extern "C" int tip_em_sweep_large_k(
    const void* theta, const void* p, const void* trip, const void* rat,
    const void* w, void* theta_hat, void* p_hat, void* ll, void* scale, int S,
    int B, int G, int K, int R, int splits, int estep_smem, int cross_threads,
    int cross_smem, void* stream) {
  return large_k::launch(large_k::GatherRows{(const float*)theta, G}, p, trip,
                         rat, w, theta_hat, p_hat, ll, scale, S, B, G, K, R,
                         splits, estep_smem, cross_threads, cross_smem, stream);
}
