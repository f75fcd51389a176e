// K4: the whole-ensemble E-step of the bdg route, with position 1's theta
// gather and theta_hat accumulation local to a gene block.  Hand-written
// for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_bdg.py,
//   _bdg_estep (_em_tile_kernel_bdg).  Same contract: rows come in the
//   g1 plan's order (stably sorted by position-1 gene block,
//   ops/em_bdg.py make_g1_plan); position 1's theta rows are read from,
//   and its theta_hat share accumulated in, one gene block at a time; the
//   position-2/3 marginals go out as streams [2, B, S*K] for plan_scatter.cu
//   with the 2-position plan; p_hat = p * cross and loglik [S] as K1.  The
//   TPU kernel's local one-hot matmuls, block-diagonal operands and S^2
//   cross matmul are not carried over, nor its tile padding of every block
//   run: the port's g1 plan has no pad rows, so a block of rows here may
//   start and end anywhere inside a gene block's run.
//
// Supported shapes: K1's range, as ops/em_bdg.py bdg_plan admits (it
// narrows the gene block wb1 and the row tile until the buffers below fit
// shared memory); any G; S <= 65535; any B >= 1.
//
// What bounds it on the H100: the E-step algebra is K1's (register-tiled
// products over each tile's rows sorted by rating inside the block,
// csrc/em_tile.cuh; 80 registers, 3 blocks per SM, the gene block's two
// [wb1, K] buffers on top of the tile buffers).  Against
// K5a (em_sweep.cu's streams form) it reads position 1's theta as one contiguous [wb1, K]
// block per gene block visited (instead of a scattered row per row) and
// keeps position 1 out of the streams and out of the scatter (2 of 3
// positions' bytes), at the cost of summing into the block accumulator and
// one flush of it per gene block visited.
//
// Design, with every sum in an order fixed by the rows and the host plan
// (no atomics, the same bits from run to run): grid (pieces of piece_rows
// consecutive rows, S).  A block walks the gene blocks its piece overlaps
// (g1 CSR offsets); for each it stages theta[s, block rows] and a zeroed
// accumulator [wb1, K] in shared memory, runs the tile algebra of
// em_tile.cuh over the rows of that gene block (a tile cut short by the
// block's end costs only its rows' slot quads) and adds the tile's
// position-1 marginals into the accumulator, each gene's rows summed in row
// order by one thread (tip::keyed_sum; one writer per element).  Then it
// flushes the accumulator: a gene block whose rows lie
// inside the piece is stored into theta_hat; one that runs in from the
// piece before leaves its share in part_th as the piece's head, one that
// begins here and runs on as its tail.  fixup_kernel, as plan_scatter.cu's,
// gives each run-on gene block to the piece it began in, which adds its
// tail and the heads of the following pieces in piece order and stores the
// sum once, so a hub gene block split over many pieces is summed by a
// fixed order too.  p * cross and w log D go into the block's slot of the
// partial buffer part_p (tip::flush_part), which csrc/block_sum.cu sums in
// block order.  Splitting by restart keeps the block at [wb1, K] per
// buffer: [wb1, S*K] would be 205 KB at wb1 = 512, S = 10, K = 10.

#include "em_tile.cuh"

namespace {

// Largest q in [0, Q) with off[q] <= i (the CSR block that holds row i).
__device__ inline int block_of(const int* __restrict__ off, int Q, int i) {
  int lo = 0, hi = Q - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(tip::kThreads, 3) em_bdg_kernel(
    const float* __restrict__ theta,   // [S, G, K]
    const float* __restrict__ p,       // [S, K, K, K, R]
    const int* __restrict__ trip,      // [B, 3], g1 plan order
    const int* __restrict__ rat,       // [B]
    const float* __restrict__ w,       // [B]
    const int* __restrict__ g1_lid,    // [B] g1 - block * wb1
    const int* __restrict__ g1_off,    // [Q1 + 1] row offsets per g1 block
    float* __restrict__ streams,       // [2, B, S*K]: positions 2 and 3
    float* __restrict__ theta_hat,     // [S, G, K], zeroed by the caller
    float* __restrict__ part_th,       // [pieces, 2, S, wb1 K]: heads, tails
    float* __restrict__ part_p,        // [S, pieces, K^3 R + 1]
    int B, int G, int K, int R, int Q1, int wb1, int tile, int piece_rows) {
  const int s = blockIdx.y, S = gridDim.y;
  const int K3 = K * K * K, SK = S * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ float smem[];
  const tip::Tile t = tip::carve(smem, K, R, tile);
  const int RS = t.RS, W = wb1 * K;
  float* th_blk = t.rest;         // [wb1][K] theta rows of the gene block
  float* acc = th_blk + wb1 * K;  // [wb1][K] its theta_hat share
  int* key = t.link;

  tip::stage_p(t, p + (size_t)s * K3 * R);
  const float* th_s = theta + (size_t)s * G * K;
  float* thh_s = theta_hat + (size_t)s * G * K;
  float ll_acc = 0.f;
  const int r0 = blockIdx.x * piece_rows;
  const int r1 = min(B, r0 + piece_rows);
  const size_t GK = (size_t)G * K;
  __syncthreads();

  for (int q = block_of(g1_off, Q1, r0); q < Q1 && g1_off[q] < r1; ++q) {
    const int a = max(r0, g1_off[q]), e = min(r1, g1_off[q + 1]);
    if (a >= e) continue;  // uniform across the block
    const size_t base = (size_t)q * wb1 * K;
    for (int i = tid; i < wb1 * K; i += nt) {
      th_blk[i] = base + i < GK ? th_s[base + i] : 0.f;
      acc[i] = 0.f;
    }
    __syncthreads();

    for (int row0 = a; row0 < e; row0 += tile) {
      const int n = min(tile, e - row0);
      // Row metadata; position 1 keeps its local id.  Out-of-range ids
      // make a row inert, as in em_sweep.cu.
      for (int i = tid; i < tile; i += nt) {
        const int b = row0 + i;
        int l1 = 0, g2 = 0, g3 = 0, r = 0;
        bool valid = i < n;
        if (valid) {
          l1 = g1_lid[b];
          g2 = trip[3 * b + 1];
          g3 = trip[3 * b + 2];
          r = rat[b];
          valid = (unsigned)l1 < (unsigned)wb1 &&
                  (size_t)(q * wb1 + l1) < (size_t)G &&
                  (unsigned)g2 < (unsigned)G && (unsigned)g3 < (unsigned)G &&
                  (unsigned)r < (unsigned)R;
        }
        t.gene[i] = valid ? l1 : 0;
        t.gene[RS + i] = valid ? g2 : 0;
        t.gene[2 * RS + i] = valid ? g3 : 0;
        t.rr[i] = valid ? r : 0;
        t.wv[i] = valid ? w[b] : 0.f;
      }
      __syncthreads();
      tip::sort_rows(t, n);

      tip::Walk3 it(tid, nt, K);
      for (int i = tid; i < 3 * K * n; i += nt, it.next()) {
        const int g = t.gene[it.pos * RS + it.row];
        tip::th_at(t, it.pos, it.k, t.slot[it.row]) =
            it.pos == 0 ? th_blk[g * K + it.k] : th_s[(size_t)g * K + it.k];
      }
      __syncthreads();

      ll_acc += tip::estep(t, n);

      // Position 1: each gene's rows summed in row order by one thread,
      // into the accumulator.
      for (int row = tid; row < n; row += nt)
        key[row] = t.wv[row] != 0.f ? t.gene[row] : -1;
      __syncthreads();
      tip::keyed_sum(
          t, n, K, [&](int row, int k) { return tip::marginal(t, 0, k, row); },
          [&](int l1, int k) { return acc + l1 * K + k; });
      // streams[pos - 1, b, s*K + k] for positions 2 and 3.
      for (int i = tid; i < 2 * K * n; i += nt) {
        const int k = i % K, rest = i / K;
        const int row = rest % n, pos = 1 + rest / n;
        streams[((size_t)(pos - 1) * B + row0 + row) * SK + s * K + k] =
            tip::marginal(t, pos, k, row);
      }
      tip::cross_acc(t, n);  // ends synced: acc is complete for this tile
    }

    // Flush: inside the piece into theta_hat, a head or a tail into part_th.
    const bool head = g1_off[q] < r0;
    const bool tail = !head && g1_off[q + 1] > r1;
    if (head || tail) {
      float* dst = part_th + ((size_t)(2 * blockIdx.x + (tail ? 1 : 0)) * S + s) * W;
      for (int i = tid; i < W; i += nt) dst[i] = acc[i];
    } else {
      for (int i = tid; i < W; i += nt)
        if (base + i < GK) thh_s[base + i] = acc[i];
    }
    __syncthreads();  // before the next gene block overwrites th_blk, acc
  }
  float* pp = part_p + ((size_t)s * gridDim.x + blockIdx.x) * ((size_t)K3 * R + 1);
  tip::flush_part(t, pp, ll_acc, pp + (size_t)K3 * R);
}

// Each run-on gene block to the piece it began in: its tail plus the heads
// of the following pieces, in piece order, stored once into theta_hat.
// Grid (pieces, S).
__global__ void fixup_kernel(const int* __restrict__ g1_off,
                             const float* __restrict__ part_th,
                             float* __restrict__ theta_hat, int B, int G, int K,
                             int Q1, int wb1, int piece_rows) {
  const int j = blockIdx.x, s = blockIdx.y, S = gridDim.y, n_pieces = gridDim.x;
  const int W = wb1 * K;
  const int r0 = j * piece_rows, r1 = min(B, r0 + piece_rows);
  const int q = block_of(g1_off, Q1, r1 - 1);  // the piece's last gene block
  if (g1_off[q] < r0 || g1_off[q + 1] <= r1) return;  // not a tail
  const size_t GK = (size_t)G * K, base = (size_t)q * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    float acc = part_th[((size_t)(2 * j + 1) * S + s) * W + i];
    for (int m = j + 1; m < n_pieces; ++m) {
      acc += part_th[((size_t)(2 * m) * S + s) * W + i];
      if (g1_off[q + 1] <= min(B, (m + 1) * piece_rows)) break;
    }
    if (base + i < GK) theta_hat[(size_t)s * GK + base + i] = acc;
  }
}

}  // namespace

// Launch both kernels on `stream`; returns cudaGetLastError() (0 on
// success).  There are (B + piece_rows - 1) / piece_rows pieces; the caller
// zeroes theta_hat, allocates part_th and part_p for them (ops/em_bdg.py
// bdg_buffers) and sizes smem_bytes from the host plan (ops/em_bdg.py
// bdg_plan).
extern "C" int tip_em_bdg(const void* theta, const void* p, const void* trip,
                          const void* rat, const void* w, const void* g1_lid,
                          const void* g1_off, void* streams, void* theta_hat,
                          void* part_th, void* part_p, int S, int B, int G, int K,
                          int R, int Q1, int wb1, int tile, int piece_rows,
                          int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        em_bdg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + piece_rows - 1) / piece_rows, S);
  em_bdg_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)w, (const int*)g1_lid, (const int*)g1_off, (float*)streams,
      (float*)theta_hat, (float*)part_th, (float*)part_p, B, G, K, R, Q1, wb1,
      tile, piece_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fixup_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int*)g1_off, (const float*)part_th, (float*)theta_hat, B, G, K, Q1,
      wb1, piece_rows);
  return (int)cudaGetLastError();
}
