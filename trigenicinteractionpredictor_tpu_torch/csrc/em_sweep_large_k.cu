// K3: the whole-ensemble EM sweep for large K (21 <= K <= 72), hand-written
// for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em.py,
//   _em_tile_kernel (launched by _pallas_stats) in its ensemble, grouped and
//   single-restart forms.  Same contract as K1 (csrc/em_sweep.cu):
//   theta_hat [S,G,K], p_hat = p * cross [S,K,K,K,R] and loglik [S] of the
//   pre-update state, equal to the batched plain sweep of ops/em.py.  Rows
//   arrive unsorted; the wrapper hands the kernel a stable rating order of
//   them (an index array), through which both passes read.  The TPU kernel's
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
// The two passes (an E-step pass of register-tiled products over k-slices
// of p, staged by cp.async from a packed copy, and a cross-stat pass of
// register-tiled rank updates over one rating's rows), what bounds them on
// the H100 (the float32 FMA rate; ~45% of it in pass 1 at K = 72, ~20% in
// pass 2; 96 and 127 registers by ptxas), their shared memory, how inert
// rows are handled and how every sum keeps a fixed order (no atomics) are
// described in csrc/em_large_k.cuh, which K7
// (csrc/em_hybrid.cu) shares.
// Here a row's theta values are read through its gene ids from theta
// (GatherRows); theta (G S K floats) and p stay L2-resident.

#include "em_large_k.cuh"

// Launch the pack and both passes on `stream`; returns cudaGetLastError()
// (0 on success).  The caller allocates and zeroes the buffers and
// computes the rating order and its segments (order, off) as
// large_k::launch says, and sizes the blocks and shared memory from the
// host plan (ops/em_large_k.py sweep_plan, shared by K3 and K7).
extern "C" int tip_em_sweep_large_k(
    const void* theta, const void* p, const void* trip, const void* w,
    const void* order, const void* off, void* pk, void* streams, void* p_part,
    void* ll_part, void* scale, void* rowinfo, int S, int B, int G, int K, int R,
    int KC, int estep_threads, int estep_smem, int nk, int splits, int vec,
    int cross_threads, int cross_smem, void* stream) {
  return large_k::launch(large_k::GatherRows{(const float*)theta, G}, p, trip,
                         w, order, off, pk, streams, p_part, ll_part, scale, rowinfo,
                         S, B, G, K, R, KC, estep_threads, estep_smem, nk, splits, vec,
                         cross_threads, cross_smem, stream);
}
