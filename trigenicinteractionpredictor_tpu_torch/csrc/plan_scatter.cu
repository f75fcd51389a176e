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
//   (em_sweep.cu, em_bdg.cu, em_large_k.cuh).  The plan (ops/em_large_g.py
//   make_scatter_plan) gives the slots in gene order (perm), each slot's
//   gene as a local id in its wb-gene block (lid) and the blocks' CSR
//   offsets (off); it has no pad slots.  The TPU kernel's local one-hot
//   [tile, wb] matmul per tile and its tile-padded block runs are not
//   carried over.
//
// What bounds it on the H100: memory.  Each slot reads one S*K-float row of
// the stream at a random position (perm) plus two ints; at B = 131,072,
// S = 10, K = 10 that is 105 MB (2 positions) to 157 MB (3) a sweep, and
// theta_hat (4 S G K bytes) is read and written once.  A gene has only a
// few slots (2.6 at G = 100,000), so what the card must hide is latency:
// enough row reads, and enough theta_hat reads, in flight on every SM.
//
// Design, deterministic and free of atomics:
// - the sorted slots are cut into pieces of `piece` slots; a block takes a
//   tile of up to 128 of the S*K columns and walks every grid-th piece;
// - a thread owns one group of VEC columns (16 bytes where S*K is a
//   multiple of 4, else 8 or 4) and every RL-th slot of the piece, RL =
//   256 / (column groups rounded up to a power of two): lanes are (slot,
//   column group) pairs, so narrow streams (S*K = 10) fill a warp as wide
//   ones do, and no index is divided in a loop.  The host sizes a piece at
//   about 32 KB of rows (64 slots at S*K = 100, 512 at S*K = 10);
// - the walk is a cp.async pipeline: while a piece is summed and flushed,
//   the copies of the next piece's rows into the other half of shared
//   memory (every row of the piece at once, whatever its segments are) and
//   of the slot and local ids of the piece after it are in flight, so the
//   latency of the random row reads and of the theta_hat reads is hidden
//   behind each other; three blocks an SM;
// - for its piece the block searches the CSR offsets for each slot's gene
//   id (all slots at once); the thread of a segment's first slot sums its
//   columns over the segment from shared memory, in slot order, into that
//   first row;
// - a segment inside the piece is added into theta_hat by that thread alone
//   (one writer per element), eight read-modify-writes in flight a thread;
// - a segment that crosses a piece boundary leaves its share in part[]:
//   the share of a segment that began in an earlier piece (head), or of
//   one that begins here and runs on (tail); each piece also records its
//   first and last gene in edge[];
// - the fix-up kernel, from edge[] alone, gives each run-on segment to the
//   piece it began in, which adds its tail and the heads of the following
//   pieces, in order, and writes the sum once.
// So a hub gene -- a query gene in a large share of rows -- is summed by
// as many blocks as it has pieces, not serially by one; the order of every
// sum is fixed by the plan and the piece size (not by the grid), so
// theta_hat is the same bits from run to run.  Every element of theta_hat
// gets one plain read-modify-write, so the caller may pass it zeroed or
// holding position 1's share (em_bdg.cu).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColTile = 128;  // columns per block (COL_TILE in ops/em_bd.py)
constexpr int kInFlight = 8;     // theta_hat read-modify-writes in flight per thread
constexpr int kBlocksPerSm = 3;  // resident blocks the register count is held to

// Largest q in [0, Q) with off[q] <= i (the block of slot i).
__device__ inline int block_of(const int* __restrict__ off, int Q, int i) {
  int lo = 0, hi = Q - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
}

// VEC floats of shared memory at once (p is aligned to 4 VEC bytes).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (VEC == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

// Shared memory: rows [2][piece][W] floats (W = the widest column tile, a
// multiple of VEC), then as ints gene [piece + 2] (the gene of the slot
// before the piece, of its slots, and of the slot after; -1 past either end
// of the plan), slot [3][piece] and lids [3][piece + 2] (the local ids of
// the same piece + 2 slots).  cg_log2: log2 of the threads along the column
// groups.
template <int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) segment_kernel(
    const float* __restrict__ vals,  // [P*B, SK] streams
    const int* __restrict__ perm,    // [L] slots in gene order
    const int* __restrict__ lid,     // [L]
    const int* __restrict__ off,     // [Q + 1]
    float* __restrict__ out,         // [S, G, K]
    float* __restrict__ part,        // [n_pieces, 2, SK]
    int* __restrict__ edge,          // [n_pieces, 2]: first and last gene
    int L, int Q, int wb, int SK, int K, int G, int piece, int W, int cg_log2) {
  const int tid = threadIdx.x;
  const int n_pieces = (L + piece - 1) / piece;
  const int c0 = blockIdx.y * kColTile;
  const int cw = min(kColTile, SK - c0);
  const int cg = tid & ((1 << cg_log2) - 1), rl = tid >> cg_log2;
  const int RL = kThreads >> cg_log2;
  const int mine = cg * VEC;  // the thread's first column in the tile
  const bool active = mine < cw;

  extern __shared__ float4 smem4[];
  float* rows2 = reinterpret_cast<float*>(smem4);
  int* gene = reinterpret_cast<int*>(rows2 + 2 * (size_t)piece * W);
  int* slot3 = gene + piece + 2;
  int* lids3 = slot3 + 3 * piece;

  // The copies of piece pc's slot ids and local ids, and of its rows.
  auto fetch_ids = [&](int pc, int buf) {
    const int a = pc * piece, n = min(L, a + piece) - a;
    for (int i = tid; i < n; i += kThreads)
      copy_async<4>(slot3 + buf * piece + i, perm + a + i);
    for (int i = tid; i < n + 2; i += kThreads) {
      const int sl = a - 1 + i;
      if (sl >= 0 && sl < L) copy_async<4>(lids3 + buf * (piece + 2) + i, lid + sl);
    }
  };
  auto fetch_rows = [&](int pc, int buf, int ids_buf) {
    const int a = pc * piece, n = min(L, a + piece) - a;
    if (!active) return;
    float* dst = rows2 + (size_t)buf * piece * W + mine;
    const int* slot = slot3 + ids_buf * piece;
    for (int r = rl; r < n; r += RL)
      copy_async<4 * VEC>(dst + r * W, vals + (size_t)slot[r] * SK + c0 + mine);
  };

  // out[s, g, k] of column s*K + k lies at ocol + g*K.
  size_t ocol[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int col = min(c0 + mine + v, SK - 1);
    ocol[v] = (size_t)(col / K) * G * K + col % K;
  }

  const int step = gridDim.x;
  int pc = blockIdx.x;  // the host launches at most n_pieces blocks along x
  fetch_ids(pc, 0);
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  fetch_rows(pc, 0, 0);
  if (pc + step < n_pieces) fetch_ids(pc + step, 1);
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int it = 0; pc < n_pieces; ++it, pc += step) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // this piece's rows and the next one's ids have landed;
                      // everyone is done with the piece before
    if (pc + step < n_pieces) fetch_rows(pc + step, (it + 1) & 1, (it + 1) % 3);
    if (pc + 2 * step < n_pieces) fetch_ids(pc + 2 * step, (it + 2) % 3);
    asm volatile("cp.async.commit_group;" ::: "memory");

    const int a = pc * piece, n = min(L, a + piece) - a;
    float* rows = rows2 + (size_t)(it & 1) * piece * W;
    const int* lids = lids3 + (it % 3) * (piece + 2);
    for (int i = tid; i < n + 2; i += kThreads) {
      const int sl = a - 1 + i;
      gene[i] = (sl >= 0 && sl < L) ? block_of(off, Q, sl) * wb + lids[i] : -1;
    }
    __syncthreads();
    if (blockIdx.y == 0 && tid == 0) {
      edge[2 * pc] = gene[1];
      edge[2 * pc + 1] = gene[n];
    }

    // Each segment's sum, in slot order, into the row of its first slot.
    if (active) {
      for (int r = rl; r < n; r += RL) {
        const int g = gene[r + 1];
        if (r > 0 && gene[r] == g) continue;  // not a segment's first slot
        float acc[VEC], x[VEC];
        load_vec<VEC>(rows + r * W + mine, acc);
        for (int i = r + 1; i < n && gene[i + 1] == g; ++i) {
          load_vec<VEC>(rows + i * W + mine, x);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += x[v];
        }
        store_vec<VEC>(rows + r * W + mine, acc);
      }
    }
    __syncthreads();
    if (!active) continue;

    // Flush: a segment inside the piece into theta_hat, a head or a tail
    // into part[].
    const int first = gene[1], last = gene[n];
    const bool runs_in = gene[0] == first, runs_on = gene[n + 1] == last;
    float* const head = part + (size_t)(2 * pc) * SK + c0 + mine;
    for (int r0 = rl; r0 < n; r0 += RL * kInFlight) {
      float val[kInFlight][VEC];
      int kind[kInFlight];  // 0: nothing, 1: head, 2: tail, 3: theta_hat
      int gs[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int r = r0 + u * RL;
        kind[u] = gs[u] = 0;
        if (r >= n) continue;
        const int g = gene[r + 1];
        if (r > 0 && gene[r] == g) continue;
        gs[u] = g;
        kind[u] = (g == first && runs_in) ? 1 : (g == last && runs_on) ? 2
                  : (unsigned)g < (unsigned)G ? 3 : 0;
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          val[u][v] = kind[u] == 3 ? out[ocol[v] + (size_t)g * K] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (kind[u] == 0) continue;
        float sum[VEC];
        load_vec<VEC>(rows + (r0 + u * RL) * W + mine, sum);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float* dst = kind[u] == 3 ? out + ocol[v] + (size_t)gs[u] * K
                                    : head + (kind[u] - 1) * SK + v;
          *dst = val[u][v] + sum[v];
        }
      }
    }
  }
}

__global__ void fixup_kernel(
    const int* __restrict__ edge, float* __restrict__ out,
    const float* __restrict__ part, int n_pieces, int SK, int K, int G) {
  const int j = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= SK || j + 1 >= n_pieces) return;
  const int g = edge[2 * j + 1];
  if (edge[2 * (j + 1)] != g) return;                              // no run-on
  if (j > 0 && edge[2 * j - 1] == g) return;                       // began earlier
  float acc = part[(size_t)(2 * j + 1) * SK + c];
  for (int m = j + 1;; ++m) {
    acc += part[(size_t)(2 * m) * SK + c];
    if (m + 1 >= n_pieces || edge[2 * (m + 1)] != g) break;
  }
  if ((unsigned)g < (unsigned)G)
    out[((size_t)(c / K) * G + g) * K + c % K] += acc;
}

}  // namespace

// Launch both kernels on `stream`; returns cudaGetLastError() (0 on
// success).  L > 0 slots in pieces of `piece`; part holds 2 * n_pieces * SK
// floats and edge 2 * n_pieces ints; vec (4, 2 or 1, the floats per copy)
// divides SK; `blocks` blocks walk the pieces of each column tile;
// smem_bytes from the host plan (ops/em_bd.py scatter_plan).
extern "C" int tip_plan_scatter(const void* vals, const void* perm,
                                const void* lid, const void* off, void* out,
                                void* part, void* edge, int L, int Q, int wb,
                                int SK, int K, int G, int piece, int vec,
                                int blocks, int smem_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_pieces = (L + piece - 1) / piece;
  const int col_tiles = (SK + kColTile - 1) / kColTile;
  const int W = SK < kColTile ? SK : kColTile;
  auto kernel = vec == 4 ? segment_kernel<4> : vec == 2 ? segment_kernel<2> : segment_kernel<1>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  int cg_log2 = 0;  // threads along the column groups: a power of two
  while ((vec << cg_log2) < W) ++cg_log2;
  kernel<<<dim3(blocks < n_pieces ? blocks : n_pieces, col_tiles), kThreads, smem_bytes, st>>>(
      (const float*)vals, (const int*)perm, (const int*)lid, (const int*)off,
      (float*)out, (float*)part, (int*)edge, L, Q, wb, SK, K, G, piece, W,
      cg_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int threads = SK < kColTile ? (SK + 31) / 32 * 32 : kColTile;
  fixup_kernel<<<dim3(n_pieces, (SK + threads - 1) / threads), threads, 0, st>>>(
      (const int*)edge, (float*)out, (const float*)part, n_pieces, SK, K, G);
  return (int)cudaGetLastError();
}
