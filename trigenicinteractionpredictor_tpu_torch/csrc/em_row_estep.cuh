// The register-resident E-step and the tile carve it runs on, shared by K1
// and K5a (csrc/em_sweep.cu) and K4 (csrc/em_bdg.cu): one algebra, two
// callers.  K9 (csrc/em_rsorted.cu) keeps the shared carve and estep() of
// csrc/em_tile.cuh, whose load_rows, sort_rows, keyed_sum, add_marginals,
// cross_acc and block_store every caller takes.
//
// - The E-step (estep_rows) is one register-resident pass per row: four
//   lanes own a row, lane j its l = j, j + 4, ...; each holds the row's
//   theta3 and its partial A3 in registers and walks p[s, k, l, :, r] once
//   per (k, l): t = sum_m th3[m] p, A3[m] += th1[k] th2[l] p from the same
//   p values, then A1[k] += th2[l] t and A2[l] += th1[k] t.  A1[k] and A3
//   are summed over the four lanes by shuffles (a fixed order), so there is
//   no T/U buffer and no barrier inside the E-step: the caller's next
//   barrier orders its writes before their readers.  2 K^3 + 3 K^2
//   multiply-adds a row, with no padded (l, m) at K = 10.  At tile 64 every
//   lane of the block owns a row; in K4, a warp whose eight rows all lie
//   at or past the tile's n (a tile cut short by a piece's end or by a
//   second gene block's end) runs no (k, l) pair, warp-uniformly, so the
//   full-mask shuffles stay legal.
// - p[s] is staged for it as [r][k][l][LS]: LS is K rounded up to a whole,
//   odd number of float4s, so the four lanes' rows of p fall in four
//   different bank quads, and a rating's slice starts 16 words (mod 32)
//   after the last, so a warp that mixes two ratings reads conflict-free.
// - K is a template parameter (KC; the registers are indexed at compile
//   time): the K = 10 instance is exact, K = 1..20 otherwise run in the
//   instance of K rounded up to 4, with zero pads past K (kc_of).
// - The carve has no T/U: p_sm, cross, then only the keys and the keyed
//   sum's lists (27 tile + 256 words), then theta, A and the per-slot and
//   per-row vectors as tip::carve lays them; t.rest is the caller's
//   (ops/em_bdr.py sweep_smem_bytes mirrors it byte for byte, and
//   ops/em_bdg.py _smem_bytes adds K4's two [wb1, K] accumulator slots at
//   t.rest).

#pragma once

#include "em_tile.cuh"

namespace tip {
namespace reg {

// The rows one pass of the block covers (four lanes a row): the largest
// tile, and the one an instance with R fixed runs at.
constexpr int kPassRows = tip::kThreads / 4;



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
// read.  With SKIP, a warp whose eight rows all lie at or past n runs no
// (k, l) pair (warp-uniform: its shuffles of zeros stay legal) and writes
// nothing, as before: K4, whose tiles a piece's end or a second gene
// block's end cuts short.
// K1 has one short tile a block and leaves it off (its K = 10, R = 2
// instance would spill at 64 registers).  Returns this thread's share of
// sum w log D.
template <int KC, bool SKIP = false>
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
  const int k_end = !SKIP || 8 * (threadIdx.x >> 5) < n ? K : 0;  // no row, no (k, l)
  for (int k = 0; k < k_end; ++k, pk += KC * LS) {
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

}  // namespace reg
}  // namespace tip
