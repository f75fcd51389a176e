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
// multiply-adds (2 K^3 in the E-step, K^3 in the p cross-stats) against
// K^3 R values of p[s].  At K = 10 that is far below the card's float32
// rate and its HBM bandwidth: theta (400 KB at G = 1000, S = 10) and p stay
// L2-resident, so the limits are the block's barriers and latencies, the
// shared-memory reads of the K^3 products and placing the 3 K marginals of
// each row.
//
// Design:
// - grid (row blocks, S): a block owns one restart s and a contiguous run
//   of rows, walked in tiles of `tile` rows.  The host plan (ops/em_bdr.py
//   sweep_grid) sizes the run so that the grid is one to three waves of
//   the blocks an SM holds (4 at K = 10, R = 2, else 3, fewer where shared
//   memory binds); the SM count is fixed on a given card, so the plan, and
//   with it the order of every sum, is too;
// - p[s] is staged once in shared memory and the p cross-stats stay there
//   for the block's whole run; per tile the rows are sorted by rating
//   inside the block (tip::load_rows) and the cross-stats are a
//   register-tiled product over each rating's rows (tip::cross_acc;
//   csrc/em_tile.cuh, which K4 and K9 share, gives its layout);
// - the E-step (estep_rows below) is one register-resident pass per row:
//   four lanes own a row, lane j its l = j, j + 4, ...; each holds the
//   row's theta3 and its partial A3 in registers and walks p[s, k, l, :, r]
//   once per (k, l): t = sum_m th3[m] p, A3[m] += th1[k] th2[l] p from the
//   same p values, then A1[k] += th2[l] t and A2[l] += th1[k] t.  A1[k] and
//   A3 are summed over the four lanes by shuffles (a fixed order), so
//   there is no T/U buffer and no barrier inside the E-step: the key sum's
//   barrier after its keys (or, for the streams, one barrier) orders its
//   writes before their readers.  2 K^3 + 3 K^2 multiply-adds a row, with
//   no padded (l, m) at K = 10.  At tile 64 every lane of the block owns a
//   row.  p[s] is staged for it as [r][k][l][LS]: LS is K rounded up to a
//   whole, odd number of float4s, so the four lanes' rows of p fall in four
//   different bank quads, and a rating's slice starts 16 words (mod 32)
//   after the last, so a warp that mixes two ratings reads conflict-free;
// - K is a template parameter of the E-step (its registers are indexed at
//   compile time): the K = 10 instance is exact, K = 1..20 otherwise run
//   in the instance of K rounded up to 4, with zero pads past K.  The main
//   path's K = 10, R = 2 has an instance with R fixed too: its buffers sit
//   at fixed offsets, which frees the registers for four blocks an SM (64
//   registers, no spill, 49 KB each; with R a runtime value 64 registers
//   spill, and three blocks an SM ran K1 ~10% slower, PERF.md section 6);
//   every other instance takes up to 80 registers, three blocks an SM;
// - every block owns a slot [LD] of the partial buffer part [S, blocks,
//   LD]: its p * cross [K,K,K,R] and its sum w log D (flush_part), and,
//   for K1, its private theta_hat [G, K] in front of them, LD = G K + K^3 R
//   + 1.  Per tile the marginals of each gene are summed over the tile's
//   entries (row, position) of that gene in entry order and added once
//   into the private theta_hat by one lane (tip::add_marginals: each gene
//   keyed to one warp, whose lanes take its (gene, k) items): no atomics.
//   The tile ends without a barrier after the cross-stats: warps with no
//   cross item go on to the next tile's row load, whose first barrier
//   comes before anything the cross-stats read is overwritten;
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

// The floats of one row of p[s, k, l, :, r] in K1's staging: KC rounded up
// to a whole float4, and to an odd number of them.
__host__ __device__ constexpr int p_row_stride(int kc) {
  return ((kc + 3) / 4) % 2 ? (kc + 3) / 4 * 4 : (kc + 3) / 4 * 4 + 4;
}

// The floats of one rating's slice [K][KC][LS], rounded up to 16 mod 32.
__host__ __device__ constexpr int p_rating_stride(int k, int kc) {
  return k * kc * p_row_stride(kc) + (48 - k * kc * p_row_stride(kc) % 32) % 32;
}

// The instance that runs K (ops/em_bdr.py sweep_kc mirrors it).
__host__ __device__ constexpr int kc_of(int k) { return k == 10 ? 10 : (k + 3) & ~3; }

// The tile buffers of csrc/em_tile.cuh with K1's own p staging and no T/U:
// p_sm [R][K][KC][LS] (rating stride p_rating_stride), cross [R][K][K4][K4],
// then only the keys and the keyed sum's lists (27 tile + 256 words) where
// the shared carve has T/U, then theta, A and the per-slot and per-row
// vectors as tip::carve lays them (ops/em_bdr.py sweep_smem_bytes mirrors
// it byte for byte).
template <int KC>
__device__ inline tip::Tile carve(float* smem, int K, int R, int tile) {
  tip::Tile t;
  t.K = K;
  t.R = R;
  t.tile = tile;
  t.RS = tile;
  t.K4 = (K + 3) & ~3;
  t.NS = ((tile + 3) & ~3) + 4 * (R - 1);
  const int NS = t.NS, K4 = t.K4;
  t.p_sm = smem;
  t.cross = t.p_sm + R * p_rating_stride(K, KC);
  t.TV = t.cross + R * K * K4 * K4;
  t.link = reinterpret_cast<int*>(t.TV);
  t.th = t.TV + 27 * tile + 32 * tip::kBuckets;
  t.A = t.th + 3 * K4 * NS;
  t.wvs = t.A + 3 * K * NS;
  t.scale = t.wvs + NS;
  t.wv = t.scale + NS;
  t.gene = reinterpret_cast<int*>(t.wv + tile);
  t.rr = t.gene + 3 * tile;
  t.slot = t.rr + tile;
  t.seg = t.slot + tile;
  t.rest = reinterpret_cast<float*>(t.seg + 8);
  return t;
}

// Stage p[s] in K1's layout (zeros past K), zero the cross-stats and the
// theta buffer (its pads stay 0).  The caller syncs before use.
template <int KC>
__device__ inline void stage_p(const tip::Tile& t, const float* __restrict__ p_s) {
  constexpr int LS = p_row_stride(KC);
  const int K = t.K, K4 = t.K4, R = t.R, RST = p_rating_stride(K, KC);
  for (int i = threadIdx.x; i < R * RST; i += blockDim.x) {
    const int r = i / RST, rest = i - r * RST;
    const int m = rest % LS, kl = rest / LS, l = kl % KC, k = kl / KC;
    t.p_sm[i] = (k < K && l < K && m < K) ? p_s[((size_t)(k * K + l) * K + m) * R + r] : 0.f;
  }
  for (int i = threadIdx.x; i < R * K * K4 * K4; i += blockDim.x) t.cross[i] = 0.f;
  for (int i = threadIdx.x; i < 3 * K4 * t.NS; i += blockDim.x) t.th[i] = 0.f;
}

// A1..A3 and scale = w/D of the tile's n rows, one pass over p per row:
// row tid / 4, lane j = tid % 4 takes l = j, j + 4, ... (see the header).
// Enter with the rows loaded (tip::load_rows, synced); writes A at the
// rows' slots and scale at every used slot (0 where the weight is 0: pads
// and weight-0 rows), with no barrier: the caller syncs before they are
// read.  Returns this thread's share of sum w log D.
template <int KC>
__device__ inline float estep_rows(const tip::Tile& t, int n) {
  constexpr int LS = p_row_stride(KC), LQ = (KC + 3) / 4;
  constexpr unsigned kAll = 0xffffffffu;
  const int K = t.K, K4 = t.K4, NS = t.NS;
  const int j = threadIdx.x & 3, row = threadIdx.x >> 2;
  const bool valid = row < n;  // the other lanes run row 0 and write nothing
  const int s = t.slot[valid ? row : 0];
  const float* th1 = t.th + s;
  const float* th2 = th1 + K4 * NS;
  const float* th3 = th2 + K4 * NS;
  float x3[KC], a3[KC], x2[LQ], a2[LQ];
#pragma unroll
  for (int m = 0; m < KC; ++m) {
    x3[m] = th3[m * NS];
    a3[m] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < LQ; ++i) {
    x2[i] = j + 4 * i < KC ? th2[(j + 4 * i) * NS] : 0.f;
    a2[i] = 0.f;
  }
  const float* pk = t.p_sm + t.rr[valid ? row : 0] * p_rating_stride(K, KC) + j * LS;
  float d = 0.f;
  for (int k = 0; k < K; ++k, pk += KC * LS) {
    const float x1 = th1[k * NS];
    float a1 = 0.f;
#pragma unroll
    for (int i = 0; i < LQ; ++i) {
      if (j + 4 * i < KC) {
        float pv[4 * LQ];
#pragma unroll
        for (int q = 0; q < LQ; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(pk + 4 * i * LS + 4 * q);
          pv[4 * q] = v.x;
          pv[4 * q + 1] = v.y;
          pv[4 * q + 2] = v.z;
          pv[4 * q + 3] = v.w;
        }
        const float c = x1 * x2[i];
        float tt = 0.f;
#pragma unroll
        for (int m = 0; m < KC; ++m) {
          tt = fmaf(x3[m], pv[m], tt);
          a3[m] = fmaf(c, pv[m], a3[m]);
        }
        a1 = fmaf(x2[i], tt, a1);
        a2[i] = fmaf(x1, tt, a2[i]);
      }
    }
    a1 += __shfl_xor_sync(kAll, a1, 1);
    a1 += __shfl_xor_sync(kAll, a1, 2);
    if (valid && (k & 3) == j) t.A[k * NS + s] = a1;
    d = fmaf(x1, a1, d);
  }
#pragma unroll
  for (int m = 0; m < KC; ++m) {
    a3[m] += __shfl_xor_sync(kAll, a3[m], 1);
    a3[m] += __shfl_xor_sync(kAll, a3[m], 2);
    if (valid && m < K && (m & 3) == j) t.A[(2 * K + m) * NS + s] = a3[m];
  }
#pragma unroll
  for (int i = 0; i < LQ; ++i)
    if (valid && j + 4 * i < K) t.A[(K + j + 4 * i) * NS + s] = a2[i];
  float ll = 0.f;
  const float wi = t.wvs[s];
  if (valid && j == 0 && wi != 0.f) {
    t.scale[s] = wi / (d + tip::kEps);
    ll = wi * logf(d + tip::kEps);
  }
  for (int i = threadIdx.x; i < t.seg[t.R]; i += blockDim.x)
    if (t.wvs[i] == 0.f) t.scale[i] = 0.f;
  return ll;
}

// Write the block's p-stats p * cross into pp, its [K, K, K, R] slot of the
// partial buffer (every cell), and its sum w log D into *lp.
template <int KC>
__device__ inline void flush_part(const tip::Tile& t, float* __restrict__ pp,
                                  float ll_acc, float* __restrict__ lp) {
  constexpr int LS = p_row_stride(KC);
  const int K = t.K, K4 = t.K4, R = t.R, RST = p_rating_stride(K, KC);
  for (int c = threadIdx.x; c < R * K * K4 * K4; c += blockDim.x) {
    const int m = c % K4, l = (c / K4) % K4, rk = c / (K4 * K4);
    const int k = rk % K, r = rk / K;
    if (l < K && m < K)
      pp[((size_t)(k * K + l) * K + m) * R + r] =
          t.p_sm[r * RST + (k * KC + l) * LS + m] * t.cross[c];
  }
  tip::block_store(ll_acc, lp);
}

// RC: R fixed at compile time (0: any R).
template <int KC, int RC>
__global__ void __launch_bounds__(tip::kThreads, RC ? 4 : 3) em_sweep_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    const int* __restrict__ rat,      // [B]
    const float* __restrict__ w,      // [B]
    float* __restrict__ streams,      // [3, B, S*K], or null: theta_hat in part
    float* __restrict__ part,         // [S, gridDim.x, LD], zeroed by the caller
    int B, int G, int K_in, int R_in, int tile, int rows_per_block) {
  const int K = KC == 10 ? 10 : K_in;  // the exact instance knows its K
  const int R = RC ? RC : R_in;
  const int s = blockIdx.y, S = gridDim.y;
  const int K3 = K * K * K, SK = S * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ float smem[];
  const tip::Tile t = carve<KC>(smem, K, R, tile);

  const size_t GK = streams ? 0 : (size_t)G * K;
  const size_t LD = GK + (size_t)K3 * R + 1;
  float* part_b = part + ((size_t)s * gridDim.x + blockIdx.x) * LD;
  stage_p<KC>(t, p + (size_t)s * K3 * R);
  const float* th_s = theta + (size_t)s * G * K;
  float ll_acc = 0.f;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(B, row_begin + rows_per_block);
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += tile) {
    const int n = min(tile, row_end - row0);

    tip::load_rows(t, trip, rat, w, th_s, row0, n, G);
    ll_acc += estep_rows<KC>(t, n);

    if (streams) {
      __syncthreads();  // A and scale
      // streams[pos, b, s*K + k]; inert rows write 0 (scale is 0).
      for (int i = tid; i < 3 * K * n; i += nt) {
        const int k = i % K, rest = i / K;
        const int row = rest % n, pos = rest / n;
        streams[((size_t)pos * B + row0 + row) * SK + s * K + k] =
            tip::marginal(t, pos, k, row);
      }
    } else {
      tip::add_marginals(t, n, part_b);  // its barrier after the keys covers A and scale
    }
    tip::cross_acc(t, n, false);  // the next tile's first barrier covers it
  }
  __syncthreads();  // the cross-stats, whose cells flush_part reads by another mapping
  flush_part<KC>(t, part_b + GK, ll_acc, part_b + GK + (size_t)K3 * R);
}

template <int KC, int RC = 0>
int launch(const void* theta, const void* p, const void* trip, const void* rat,
           const void* w, void* streams, void* part, int S, int B, int G, int K,
           int R, int tile, int rows_per_block, int threads, int smem_bytes,
           cudaStream_t stream) {
  // Set every launch: past 48 KB less the static buffer the default refuses.
  const cudaError_t e = cudaFuncSetAttribute(
      em_sweep_kernel<KC, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + rows_per_block - 1) / rows_per_block, S);
  em_sweep_kernel<KC, RC><<<grid, threads, smem_bytes, stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)w, (float*)streams, (float*)part, B, G, K, R, tile,
      rows_per_block);
  return (int)cudaGetLastError();
}

template <int KC, int RC = 0>
int occupancy(int smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      em_sweep_kernel<KC, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, em_sweep_kernel<KC, RC>,
                                                      tip::kThreads, smem_bytes);
  return e == cudaSuccess ? blocks : -(int)e;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The grid
// is ((B + rows_per_block - 1) / rows_per_block, S) blocks; the caller
// zeroes part (those blocks' slots, see above) and sizes smem_bytes from the
// host plan (ops/em_bdr.py sweep_plan, sweep_grid).
extern "C" int tip_em_sweep(const void* theta, const void* p, const void* trip,
                            const void* rat, const void* w, void* streams,
                            void* part, int S, int B, int G, int K, int R,
                            int tile, int rows_per_block, int threads,
                            int smem_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (K == 10 && R == 2)
    return launch<10, 2>(theta, p, trip, rat, w, streams, part, S, B, G, K, R, tile,
                         rows_per_block, threads, smem_bytes, st);
#define TIP_SWEEP(KC)                                                         \
  case KC:                                                                    \
    return launch<KC>(theta, p, trip, rat, w, streams, part, S, B, G, K, R,  \
                      tile, rows_per_block, threads, smem_bytes, st)
  switch (K >= 1 && K <= 20 ? kc_of(K) : 0) {
    TIP_SWEEP(4);
    TIP_SWEEP(8);
    TIP_SWEEP(10);
    TIP_SWEEP(12);
    TIP_SWEEP(16);
    TIP_SWEEP(20);
  }
#undef TIP_SWEEP
  return (int)cudaErrorInvalidValue;
}

// Blocks of (K, R)'s instance one SM holds at smem_bytes each (the CUDA
// occupancy calculator), or minus a CUDA error.
extern "C" int tip_em_sweep_occupancy(int K, int R, int smem_bytes) {
  if (K == 10 && R == 2) return occupancy<10, 2>(smem_bytes);
  switch (K >= 1 && K <= 20 ? kc_of(K) : 0) {
    case 4: return occupancy<4>(smem_bytes);
    case 8: return occupancy<8>(smem_bytes);
    case 10: return occupancy<10>(smem_bytes);
    case 12: return occupancy<12>(smem_bytes);
    case 16: return occupancy<16>(smem_bytes);
    case 20: return occupancy<20>(smem_bytes);
  }
  return -(int)cudaErrorInvalidValue;
}
