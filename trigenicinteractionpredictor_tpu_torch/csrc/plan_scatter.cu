// K5b and the second stage of K6: theta_hat as the segment sum of the
// gene-sorted value streams, along the host plan.  Hand-written for Hopper
// (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_bd.py,
//   _plan_scatter, and the second pallas_call of
//   trigenicinteractionpredictor_tpu/ops/pallas_em_large.py,
//   _pallas_stats_large; both run _scatter_tile_kernel.  Same contract:
//   theta_hat[s, g, k] += sum over the plan's slots of gene g of
//   vals[slot, s*K + k], vals = the [P*B, S*K] stream of the E-step
//   (em_streams.cu, em_bdg.cu).  The plan (ops/em_large_g.py
//   make_scatter_plan) gives the slots in gene order (perm), each slot's
//   gene as a local id in its wb-gene block (lid) and the blocks' CSR
//   offsets (off); it has no pad slots.  The TPU kernel's local one-hot
//   [tile, wb] matmul per tile and its tile-padded block runs are not
//   carried over.
//
// What bounds it on the H100: memory.  Each slot reads one S*K-float row of
// the stream at a random position (perm) plus two ints; at B = 131,072,
// S = 10, K = 10 that is 105 MB (2 positions) to 157 MB (3) a sweep.
//
// Design, deterministic and free of atomics:
// - the sorted slots are cut into pieces of `piece` slots; a block takes a
//   piece and a tile of the S*K columns, a thread one column, and walks the
//   piece in order, summing each gene's run (segment) in a register;
// - a segment that lies inside the piece is added into theta_hat by the
//   thread that summed it: one writer per element;
// - a segment that crosses a piece boundary leaves its share in part[]:
//   the share of a segment that began in an earlier piece (head), or of
//   one that begins here and runs on (tail);
// - the fix-up kernel gives each run-on segment to the piece it began in,
//   which adds its tail and the heads of the following pieces, in order,
//   and writes the sum once.
// So a hub gene -- a query gene in a large share of rows -- is summed by
// as many blocks as it has pieces, not serially by one; and theta_hat is
// the same bits from run to run.  Every element of theta_hat gets one
// plain read-modify-write, so the caller may pass it zeroed or holding
// position 1's share (em_bdg.cu).

#include <cuda_runtime.h>

namespace {

// Largest q in [0, Q) with off[q] <= i (the block of slot i).
__device__ inline int block_of(const int* __restrict__ off, int Q, int i) {
  int lo = 0, hi = Q - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ inline int gene_at(const int* __restrict__ off,
                              const int* __restrict__ lid, int Q, int wb, int i) {
  return block_of(off, Q, i) * wb + lid[i];
}

__global__ void segment_kernel(
    const float* __restrict__ vals,  // [P*B, SK] streams
    const int* __restrict__ perm,    // [L] slots in gene order
    const int* __restrict__ lid,     // [L]
    const int* __restrict__ off,     // [Q + 1]
    float* __restrict__ out,         // [S, G, K]
    float* __restrict__ part,        // [n_pieces, 2, SK]
    int L, int Q, int wb, int SK, int K, int G, int piece) {
  const int j = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= SK) return;
  const int a = j * piece, e = min(L, a + piece);
  const int prev = a > 0 ? gene_at(off, lid, Q, wb, a - 1) : -1;
  const int next = e < L ? gene_at(off, lid, Q, wb, e) : -1;
  const size_t col = (size_t)(c / K) * G * K + c % K;  // out[s, 0, k]

  int q = block_of(off, Q, a);
  int q_end = off[q + 1];
  int g = q * wb + lid[a];
  int start = a;
  float acc = 0.f;
  for (int i = a;; ++i) {
    int gi = -1;
    if (i < e) {
      while (i >= q_end) q_end = off[++q + 1];
      gi = q * wb + lid[i];
    }
    if (gi != g) {  // the segment [start, i) of gene g ends here
      if (start == a && prev == g) {
        part[(size_t)(2 * j) * SK + c] = acc;        // head
      } else if (i == e && next == g) {
        part[(size_t)(2 * j + 1) * SK + c] = acc;    // tail
      } else if ((unsigned)g < (unsigned)G) {
        out[col + (size_t)g * K] += acc;
      }
      if (i == e) break;
      g = gi;
      start = i;
      acc = 0.f;
    }
    acc += vals[(size_t)perm[i] * SK + c];
  }
}

__global__ void fixup_kernel(
    const int* __restrict__ lid, const int* __restrict__ off,
    float* __restrict__ out, const float* __restrict__ part,
    int L, int Q, int wb, int SK, int K, int G, int piece) {
  const int j = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= SK) return;
  const int a = j * piece, e = min(L, a + piece);
  if (e >= L) return;
  const int g = gene_at(off, lid, Q, wb, e - 1);
  if (gene_at(off, lid, Q, wb, e) != g) return;              // no run-on
  if (a > 0 && gene_at(off, lid, Q, wb, a - 1) == g) return; // began earlier
  float acc = part[(size_t)(2 * j + 1) * SK + c];
  for (int m = j + 1;; ++m) {
    acc += part[(size_t)(2 * m) * SK + c];
    const int em = min(L, (m + 1) * piece);
    if (em >= L || gene_at(off, lid, Q, wb, em) != g) break;
  }
  if ((unsigned)g < (unsigned)G)
    out[(size_t)(c / K) * G * K + (size_t)g * K + c % K] += acc;
}

}  // namespace

// Launch both kernels on `stream`; returns cudaGetLastError() (0 on
// success).  L > 0 slots; part holds 2 * ceil(L / piece) * SK floats.
extern "C" int tip_plan_scatter(const void* vals, const void* perm,
                                const void* lid, const void* off, void* out,
                                void* part, int L, int Q, int wb, int SK, int K,
                                int G, int piece, int threads, void* stream) {
  const dim3 grid((L + piece - 1) / piece, (SK + threads - 1) / threads);
  segment_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)perm, (const int*)lid, (const int*)off,
      (float*)out, (float*)part, L, Q, wb, SK, K, G, piece);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fixup_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)lid, (const int*)off, (float*)out, (const float*)part, L, Q,
      wb, SK, K, G, piece);
  return (int)cudaGetLastError();
}
