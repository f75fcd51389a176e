// The fixed-order sum of per-block partials, the second stage of every
// sweep kernel that has no atomics: K1 and K5a (em_sweep.cu), K3 and K7
// (em_large_k.cuh), K4 (em_bdg.cu) and K9 (em_rsorted.cu).  Hand-written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel by itself: it is the part of each TPU sweep
// kernel's sequential grid that carried theta_hat, p_hat and loglik in VMEM
// from one tile to the next (e.g. trigenicinteractionpredictor_tpu/ops/
// pallas_em_bdr.py, the accumulators of _em_tile_kernel_bdr over its
// sequential grid), which on the card, where blocks run in no order, is a
// second pass.
//
// Contract: up to three segments, each a partial buffer part [S, nb, ld]
// and an output out [S, c], c <= ld:
//     out[s, i] = sum over b = 0, 1, ..., nb - 1 of part[s, b, i]
// in that order, for every s < S and i < c.  A segment of c = 0 is
// skipped.  So the result depends only on the partials, not on how the
// card schedules anything.
//
// What bounds it on the H100: memory, S nb c floats read once and S c
// written once (19 MB for K1 at the headline shape, where the sweep itself
// takes ~1.3 ms).  Design: a segment of c >= 32 outputs gives each output
// a thread, which reads its partials down the blocks in order, so
// neighbouring threads read neighbouring addresses; a segment of fewer
// outputs (the loglik, c = 1, nb up to thousands of blocks) gives each
// output a warp: lane j sums blocks j, j + 32, ... in order, then the
// lanes' sums meet in a fixed shuffle tree.  One launch covers all three
// segments (grid z).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Segment {
  const float* part;  // [S, nb, ld]
  float* out;         // [S, c]
  int nb, ld, c;
};

__global__ void __launch_bounds__(kThreads) block_sum_kernel(Segment s0, Segment s1,
                                                             Segment s2) {
  const Segment g = blockIdx.z == 0 ? s0 : (blockIdx.z == 1 ? s1 : s2);
  const int s = blockIdx.y;
  const float* src = g.part + (size_t)s * g.nb * g.ld;
  if (g.c >= 32) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= g.c) return;
    float acc = 0.f;
    for (int b = 0; b < g.nb; ++b) acc += src[(size_t)b * g.ld + i];
    g.out[(size_t)s * g.c + i] = acc;
  } else {
    const int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (i >= g.c) return;  // whole warps
    float acc = 0.f;
    for (int b = lane; b < g.nb; b += 32) acc += src[(size_t)b * g.ld + i];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) g.out[(size_t)s * g.c + i] = acc;
  }
}

int blocks_for(int c) {
  return c >= 32 ? (c + kThreads - 1) / kThreads : (c + kThreads / 32 - 1) / (kThreads / 32);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Segment j
// is (part_j, out_j, nb_j, ld_j, c_j); S <= 65535.
extern "C" int tip_block_sum(const void* part0, void* out0, int nb0, int ld0, int c0,
                             const void* part1, void* out1, int nb1, int ld1, int c1,
                             const void* part2, void* out2, int nb2, int ld2, int c2,
                             int S, void* stream) {
  const Segment s0{(const float*)part0, (float*)out0, nb0, ld0, c0};
  const Segment s1{(const float*)part1, (float*)out1, nb1, ld1, c1};
  const Segment s2{(const float*)part2, (float*)out2, nb2, ld2, c2};
  int gx = blocks_for(c0);
  gx = gx > blocks_for(c1) ? gx : blocks_for(c1);
  gx = gx > blocks_for(c2) ? gx : blocks_for(c2);
  if (gx == 0 || S == 0) return 0;
  block_sum_kernel<<<dim3(gx, S, 3), kThreads, 0, (cudaStream_t)stream>>>(s0, s1, s2);
  return (int)cudaGetLastError();
}
