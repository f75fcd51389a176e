// K4: the whole-ensemble E-step of the bdg route, with position 1's
// theta_hat accumulation local to a gene block.  Hand-written for Hopper
// (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_bdg.py,
//   _bdg_estep (_em_tile_kernel_bdg).  Same contract: rows come in the
//   g1 plan's order (stably sorted by position-1 gene block,
//   ops/em_bdg.py make_g1_plan); position 1's theta_hat share is summed
//   in shared memory one gene block at a time; the position-2/3 marginals
//   go out as streams [2, B, S*K] for plan_scatter.cu with the 2-position
//   plan; p_hat = p * cross and loglik [S] as K1.  The TPU kernel's local
//   one-hot matmuls, block-diagonal operands and S^2 cross matmul are not
//   carried over, nor its tile padding of every block run: the port's g1
//   plan has no pad rows, so a tile may start and end anywhere inside a
//   gene block's run.
//
// Supported shapes: K1's range, as ops/em_bdg.py bdg_plan admits (it
// narrows the gene block wb1 and the row tile until the buffers below fit
// shared memory); any G; S <= 65535; any B >= 1.
//
// What bounds it on the H100: the E-step algebra is K1's
// (csrc/em_row_estep.cuh: K1's carve of the tile buffers, with no T/U,
// and its register-resident pass per row over each tile's rows sorted by
// rating inside the block; two [wb1, K] accumulator slots at the carve's
// end).  Every tile pays the row load, the sort, the gather, the keys and
// the cross-stats with their barriers, so the count of tiles paces the
// kernel more than its arithmetic.  A tile therefore runs on past a gene
// block's end: at G = 100,000 a gene block holds a few dozen rows, and a
// tile that stopped at each block's end cost a full tile and a short one
// per block (2,554 tiles a restart at the cell's rows, 1,594 of them
// short) where tiles of rows of up to two blocks take ~1,670
// (ops/em_bdg.py bdg_tile_census counts them).  Position 1's theta rows
// are gathered from global memory as positions 2 and 3 are (one gene
// block's rows lie in wb1 K floats), so the carve holds no theta block.
// The plan (ops/em_bdg.py bdg_plan) spends the shared memory the carve
// leaves on blocks an SM or on wider gene blocks, as the instance's
// launch bound allows.  Against K5a (em_sweep.cu's streams form) it keeps
// position 1 out of the streams and out of the scatter (2 of 3 positions'
// bytes), at the cost of summing into the block accumulators and one
// flush of them per gene block visited.
//
// Design, with every sum in an order fixed by the rows and the host plan
// (no atomics, the same bits from run to run): grid (pieces of piece_rows
// consecutive rows, S).  A block walks its piece in tiles of up to `tile`
// rows, each cut only at the piece's end or at the end of the second gene
// block it touches (g1 CSR offsets), so a tile holds rows of gene block qa
// and of the next block that holds rows, qb.  The gene blocks of the piece
// take the two accumulator slots in turn (qa slot x, qb slot x ^ 1); each
// row is keyed by (slot, local id), and the tile's position-1 marginals are
// added into the slots, each gene's rows summed in row order by one thread
// (tip::keyed_sum; one writer per element).  Once the tile that holds a
// gene block's last row of the piece is done, its slot is flushed (after
// the next tile's first barrier, so no barrier is added) and zeroed for
// the next block: a gene block whose rows lie inside the piece is stored
// into theta_hat; one that runs in from the piece before leaves its share
// in part_th as the piece's head, one that begins here and runs on as its
// tail.  fixup_kernel, as plan_scatter.cu's, gives each run-on gene block
// to the piece it began in, which adds its tail and the heads of the
// following pieces in piece order and stores the sum once, so a hub gene
// block split over many pieces is summed by a fixed order too.  p * cross
// and w log D go into the block's slot of the partial buffer part_p
// (tip::reg::flush_part), which csrc/block_sum.cu sums in block order.
// Splitting by restart keeps the slots at [wb1, K]: [wb1, S*K] would be
// 205 KB at wb1 = 512, S = 10, K = 10.  Instances as K1's: KC = kc_of(K)
// at three blocks an SM, and K = 10, R = 2 with R and the 64-row tile
// fixed at four (64 registers, no spill; with the tile a runtime value it
// spilled 24 bytes).

#include "em_row_estep.cuh"

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

// Gene block q's share of theta_hat, complete in the accumulator slot acc
// [wb1 K]: inside the piece into theta_hat, a head or a tail into part_th;
// then the slot is zeroed for the next block.
__device__ inline void flush_block(const int* __restrict__ g1_off, int q,
                                   float* __restrict__ acc,
                                   float* __restrict__ theta_hat,
                                   float* __restrict__ part_th, int B, int G, int K,
                                   int wb1, int piece_rows) {
  const int W = wb1 * K;
  const int p0 = blockIdx.x * piece_rows, p1 = min(B, p0 + piece_rows);
  const bool head = g1_off[q] < p0;
  const bool tail = !head && g1_off[q + 1] > p1;
  const size_t at = (size_t)q * W;
  if (head || tail) {
    float* dst = part_th + ((size_t)(2 * blockIdx.x + (tail ? 1 : 0)) * gridDim.y +
                            blockIdx.y) * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      dst[i] = acc[i];
      acc[i] = 0.f;
    }
  } else {
    float* out = theta_hat + (size_t)blockIdx.y * G * K + at;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      if (at + i < (size_t)G * K) out[i] = acc[i];
      acc[i] = 0.f;
    }
  }
}

// RC: R fixed at compile time, and the tile at kPassRows (0: any R, any tile).
template <int KC, int RC>
__global__ void __launch_bounds__(tip::kThreads, RC ? 4 : 3) em_bdg_kernel(
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
    int B, int G, int K_in, int R_in, int Q1, int wb1, int tile_in, int piece_rows) {
  const int K = KC == 10 ? 10 : K_in;  // the exact instance knows its K
  const int R = RC ? RC : R_in;
  // With R fixed the tile is too, so the carve's offsets are constants.
  const int tile = RC ? tip::reg::kPassRows : tile_in;
  const int s = blockIdx.y, S = gridDim.y;
  const int K3 = K * K * K, SK = S * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ float smem[];
  const tip::Tile t = tip::reg::carve<KC>(smem, K, R, tile);
  const int RS = t.RS, W = wb1 * K;
  float* acc = t.rest;  // [2][wb1][K]: the theta_hat shares of two gene blocks
  int* key = t.link;

  tip::reg::stage_p<KC>(t, p + (size_t)s * K3 * R);
  for (int i = tid; i < 2 * W; i += nt) acc[i] = 0.f;
  const float* th_s = theta + (size_t)s * G * K;
  float ll_acc = 0.f;
  const int r0 = blockIdx.x * piece_rows;
  const int r1 = min(B, r0 + piece_rows);
  // Uniform across the block: the gene block of the next tile's first row
  // and its slot, and the gene block each slot holds complete (-1: none).
  int qa = block_of(g1_off, Q1, r0), x = 0, f0 = -1, f1 = -1;
  __syncthreads();

  for (int row0 = r0; row0 < r1;) {
    if (qa + 1 < Q1 && g1_off[qa + 1] <= row0) {  // qa ended: the next block
      x ^= 1;
      do ++qa; while (qa + 1 < Q1 && g1_off[qa + 1] <= row0);
    }
    // Rows [row0, e): qa's up to row0 + na, then qb's.
    const int ea = g1_off[qa + 1];
    int e = min(row0 + tile, r1), qb = qa;
    if (e > ea && qa + 1 < Q1) {
      do ++qb; while (qb + 1 < Q1 && g1_off[qb + 1] <= ea);
      e = min(e, g1_off[qb + 1]);
    }
    e = max(e, row0 + 1);  // progress on any plan
    const int n = e - row0, na = min(ea, e) - row0;
    // Row metadata; position 1 keeps its gene id from the plan.  Out-of-range
    // ids make a row inert, as in em_sweep.cu.
    for (int i = tid; i < tile; i += nt) {
      const int b = row0 + i;
      int g1 = 0, g2 = 0, g3 = 0, r = 0;
      bool valid = i < n;
      if (valid) {
        const int l1 = g1_lid[b];
        g1 = (i < na ? qa : qb) * wb1 + l1;
        g2 = trip[3 * b + 1];
        g3 = trip[3 * b + 2];
        r = rat[b];
        valid = (unsigned)l1 < (unsigned)wb1 && (unsigned)g1 < (unsigned)G &&
                (unsigned)g2 < (unsigned)G && (unsigned)g3 < (unsigned)G &&
                (unsigned)r < (unsigned)R;
      }
      t.gene[i] = valid ? g1 : 0;
      t.gene[RS + i] = valid ? g2 : 0;
      t.gene[2 * RS + i] = valid ? g3 : 0;
      t.rr[i] = valid ? r : 0;
      t.wv[i] = valid ? w[b] : 0.f;
    }
    __syncthreads();
    // The last tile's keyed sums are done: flush its complete blocks.  The
    // keys by (slot, local id); nothing reads them before this tile's
    // key barrier.
    if (f0 >= 0) flush_block(g1_off, f0, acc, theta_hat, part_th, B, G, K, wb1, piece_rows);
    if (f1 >= 0) flush_block(g1_off, f1, acc + W, theta_hat, part_th, B, G, K, wb1, piece_rows);
    {
      const int ka = (x - qa) * wb1, kb = ((x ^ 1) - qb) * wb1;
      for (int row = tid; row < n; row += nt)
        key[row] = t.wv[row] != 0.f ? t.gene[row] + (row < na ? ka : kb) : -1;
    }
    // This tile completes qa if it reaches qa's end or the piece's, and qb
    // if it reaches qb's end or the piece's; the next tile starts in qb.
    {
      const int fa = e >= ea || e == r1 ? qa : -1;
      const int fb = qb != qa && (e == g1_off[qb + 1] || e == r1) ? qb : -1;
      f0 = x ? fb : fa;
      f1 = x ? fa : fb;
      if (qb != qa) {
        qa = qb;
        x ^= 1;
      }
    }
    tip::sort_rows(t, n);

    tip::Walk3 it(tid, nt, K);
    for (int i = tid; i < 3 * K * n; i += nt, it.next())
      tip::th_at(t, it.pos, it.k, t.slot[it.row]) =
          th_s[(size_t)t.gene[it.pos * RS + it.row] * K + it.k];
    __syncthreads();

    ll_acc += tip::reg::estep_rows<KC, true>(t, n);

    // Position 1: each gene's rows summed in row order by one thread, into
    // its block's slot.  The barrier covers A and scale.
    __syncthreads();
    tip::keyed_sum(
        t, n, K, [&](int row, int k) { return tip::marginal(t, 0, k, row); },
        [&](int slot_lid, int k) { return acc + slot_lid * K + k; });
    // streams[pos - 1, b, s*K + k] for positions 2 and 3.
    for (int i = tid; i < 2 * K * n; i += nt) {
      const int k = i % K, rest = i / K;
      const int row = rest % n, pos = 1 + rest / n;
      streams[((size_t)(pos - 1) * B + row0 + row) * SK + s * K + k] =
          tip::marginal(t, pos, k, row);
    }
    // No barrier: warps with no cross item go on to the next tile's row
    // metadata, which nothing above reads, and whose barrier comes before
    // anything they read is overwritten.
    tip::cross_acc(t, n, false);
    row0 = e;
  }
  __syncthreads();  // the last tile's keyed sums and cross-stats are done
  if (f0 >= 0) flush_block(g1_off, f0, acc, theta_hat, part_th, B, G, K, wb1, piece_rows);
  if (f1 >= 0) flush_block(g1_off, f1, acc + W, theta_hat, part_th, B, G, K, wb1, piece_rows);
  float* pp = part_p + ((size_t)s * gridDim.x + blockIdx.x) * ((size_t)K3 * R + 1);
  tip::reg::flush_part<KC>(t, pp, ll_acc, pp + (size_t)K3 * R);
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

template <int KC, int RC = 0>
int launch(const void* theta, const void* p, const void* trip, const void* rat,
           const void* w, const void* g1_lid, const void* g1_off, void* streams,
           void* theta_hat, void* part_th, void* part_p, int S, int B, int G, int K,
           int R, int Q1, int wb1, int tile, int piece_rows, int threads,
           int smem_bytes, cudaStream_t stream) {
  // Set every launch: past 48 KB less the static buffer the default refuses.
  cudaError_t e = cudaFuncSetAttribute(
      em_bdg_kernel<KC, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + piece_rows - 1) / piece_rows, S);
  em_bdg_kernel<KC, RC><<<grid, threads, smem_bytes, stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)w, (const int*)g1_lid, (const int*)g1_off, (float*)streams,
      (float*)theta_hat, (float*)part_th, (float*)part_p, B, G, K, R, Q1, wb1,
      tile, piece_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fixup_kernel<<<grid, 256, 0, stream>>>((const int*)g1_off, (const float*)part_th,
                                         (float*)theta_hat, B, G, K, Q1, wb1, piece_rows);
  return (int)cudaGetLastError();
}

template <int KC, int RC = 0>
int occupancy(int smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      em_bdg_kernel<KC, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, em_bdg_kernel<KC, RC>,
                                                      tip::kThreads, smem_bytes);
  return e == cudaSuccess ? blocks : -(int)e;
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (K == 10 && R == 2 && tile == tip::reg::kPassRows)
    return launch<10, 2>(theta, p, trip, rat, w, g1_lid, g1_off, streams, theta_hat,
                         part_th, part_p, S, B, G, K, R, Q1, wb1, tile, piece_rows,
                         threads, smem_bytes, st);
#define TIP_BDG(KC)                                                              \
  case KC:                                                                       \
    return launch<KC>(theta, p, trip, rat, w, g1_lid, g1_off, streams, theta_hat, \
                      part_th, part_p, S, B, G, K, R, Q1, wb1, tile, piece_rows,  \
                      threads, smem_bytes, st)
  switch (K >= 1 && K <= 20 ? tip::reg::kc_of(K) : 0) {
    TIP_BDG(4);
    TIP_BDG(8);
    TIP_BDG(10);
    TIP_BDG(12);
    TIP_BDG(16);
    TIP_BDG(20);
  }
#undef TIP_BDG
  return (int)cudaErrorInvalidValue;
}

// Blocks of (K, R)'s instance one SM holds at smem_bytes each (the CUDA
// occupancy calculator), or minus a CUDA error.
extern "C" int tip_em_bdg_occupancy(int K, int R, int smem_bytes) {
  if (K == 10 && R == 2) return occupancy<10, 2>(smem_bytes);
  switch (K >= 1 && K <= 20 ? tip::reg::kc_of(K) : 0) {
    case 4: return occupancy<4>(smem_bytes);
    case 8: return occupancy<8>(smem_bytes);
    case 10: return occupancy<10>(smem_bytes);
    case 12: return occupancy<12>(smem_bytes);
    case 16: return occupancy<16>(smem_bytes);
    case 20: return occupancy<20>(smem_bytes);
  }
  return -(int)cudaErrorInvalidValue;
}
