// The row-tile algebra of the E-step kernels: K1 and K5a (em_sweep.cu), K4
// (em_bdg.cu) and K9 (em_rsorted.cu).  Each kernel gathers its rows' theta
// and places the per-row position marginals its own way (K1 and K9 add them
// into a block-private theta_hat, add_marginals; K5a writes streams; K4
// writes streams and a gene block's accumulator).
//
// One block owns one restart s; p[s] and its cross-stats stay in shared
// memory for the block's whole run of rows.  Per tile of `tile` rows the
// caller fills the row metadata (gene, rr, wv, by row), calls sort_rows(),
// fills the gathered theta rows at their slots (th_at), then calls estep(),
// places the marginals th * A * scale (marginal), and calls cross_acc().
// Exact float32: no tensor cores, no TF32.
//
// Fixed-order sums, no atomics: every sum a kernel on this algebra makes
// has an order fixed by the inputs and the host plan (tile, rows per block,
// piece size), not by how warps or blocks are scheduled, so a launch gives
// the same bits from run to run.  A block writes its p-stats and its
// sum w log D into its own slot of a partial buffer (flush_part), and
// csrc/block_sum.cu sums the slots in block order.  A tile's marginals that
// fall on one key (a gene id, or a gene block's local id) are summed in
// entry order by one thread (keyed_sum), so each element of a
// block-private accumulator has one writer.
//
// What bounds it on the H100: per row and restart ~3 K^3 multiply-adds (T,
// A3 and the p cross-stats) against K^3 R values of p[s] in shared memory,
// plus 3 K marginals placed per row.  At K = 10 the products are small, so
// the limits are shared-memory reads per multiply-add and the placing of
// the marginals.  The design:
// - Rows sorted by rating inside the block (sort_rows, stable): each
//   rating's rows take a run of slots that starts at a multiple of 4, so a
//   quad of 4 slots has one rating (at most 3 pad slots a rating: weight 0,
//   theta 0).  Per-slot vectors are [component][slot], so 4 slots are one
//   float4.
// - p[s] is staged as [r][k][l][m] with l and m padded to K4 = K rounded up
//   to 4 (zeros), so 4 l's or 4 m's are one float4.
// - T[k,l] = sum_m th3[m] p[k,l,m,r] and U[k,m] = sum_l th2[l] p[k,l,m,r]
//   are register-tiled products: a thread owns 4 slots x 4 l (4 m) of one k;
//   per step it reads float4s of theta and p, 8 reads per 64 multiply-adds
//   for T and 2 per 16 for U.  A1, A2 (from T) and A3 = sum_k th1 U (from U)
//   are folded per (slot, index), K^2 per row.
// - cross[r][k,l,m] += sum over rating r's slots of th1[k] scale th2[l]
//   th3[m]: a thread owns one k, 4 l and 4 m of one rating and adds only its
//   rating's slots, 4 at a time (10 float4 reads per 80 multiply-adds): no
//   multiply-add by zero for a row of another rating.
// - No % or / per multiply-add; index walks step by constants.
// - Every kernel on this algebra is 256 threads bounded to 3 blocks per SM
//   (__launch_bounds__): 80 registers (ptxas; K1, K4 and K5a spill 8 bytes,
//   K9 none), 70,304 bytes of tile buffers at K = 10, R = 2 (64-row tiles).
//   Without the bound (115 registers, 2 blocks per SM) K1 ran 9% slower.
// - The next tile's rows are not gathered while this one computes: a second
//   theta buffer (+9.8 KB at K = 10) would leave 2 blocks per SM, not 3.
// Shared memory (floats, NS = tile rounded up to 4 plus 4 (R - 1) slots;
// the host plans ops/em_bdr.py tile_smem_bytes, ops/em_bdg.py _smem_bytes
// and ops/em_rsorted.py mirror it): 2 R K K4^2 + K^2 NS + 3 K4 NS + 3 K NS
// + 2 NS + tile floats and 5 tile + 8 ints, where K^2 NS (T/U) is at least
// 27 tile + 256: once estep() is done with T/U, the same words hold the
// keys of the tile's 3 tile entries and keyed_sum's per-warp lists until
// the next tile's estep().

#pragma once

#include <cuda_runtime.h>

namespace tip {

constexpr float kEps = 1e-30f;
// Threads per block of every kernel on this algebra (ops/em_bdr.py
// THREADS); its kernels are bounded to 3 blocks per SM (80 registers).
constexpr int kThreads = 256;
// keyed_sum's buckets, a warp each.
constexpr int kBucketBits = 3;
constexpr int kBuckets = 1 << kBucketBits;
static_assert(kBuckets * 32 == kThreads, "a bucket per warp");

struct Tile {
  int K, R, tile, RS, K4, NS;
  float* p_sm;   // [R][K][K4][K4]: p[s,k,l,m,r] at ((r*K + k)*K4 + l)*K4 + m
  float* cross;  // [R][K][K4][K4]: the same cells
  float* TV;     // [max(K^2 NS, 27 tile + 256)]: T[k,l], then U[k,m], by slot
  float* th;     // [3][K4][NS]: theta rows per position by slot; 0 past K, in pads
  float* A;      // [3][K][NS]: A1, A2, A3 by slot
  float* wvs;    // [NS]: weights by slot (0 in pads)
  float* scale;  // [NS]: w / D by slot
  float* wv;     // [RS]: weights by row
  int* gene;     // [3][RS]: gene ids by row
  int* rr;       // [RS]: ratings by row
  int* slot;     // [RS]: row -> slot
  int* seg;      // [8]: rating r's slots are seg[r] .. seg[r + 1]; seg[4 + r]
                 //      its row count
  int* link;     // over TV: keys [3 tile], then keyed_sum's lists
  float* rest;   // the first float past these buffers (kernel's own use)
};

// The buffers above, carved from the dynamic shared memory in this order.
__device__ inline Tile carve(float* smem, int K, int R, int tile) {
  Tile t;
  t.K = K;
  t.R = R;
  t.tile = tile;
  t.RS = tile;
  t.K4 = (K + 3) & ~3;
  t.NS = ((tile + 3) & ~3) + 4 * (R - 1);
  const int NS = t.NS, K4 = t.K4;
  t.p_sm = smem;
  t.cross = t.p_sm + R * K * K4 * K4;
  t.TV = t.cross + R * K * K4 * K4;
  t.th = t.TV + max(K * K * NS, 27 * tile + 32 * kBuckets);
  t.link = reinterpret_cast<int*>(t.TV);
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

// (row, pos, k) of the flat index i = (row * 3 + pos) * K + k, walked in
// steps of `step` by constants (no division in the loop).
struct Walk3 {
  int k, pos, row, dk, dp, dr, K;
  __device__ Walk3(int i, int step, int K_) : K(K_) {
    k = i % K;
    pos = (i / K) % 3;
    row = i / (3 * K);
    dk = step % K;
    dp = (step / K) % 3;
    dr = step / (3 * K);
  }
  __device__ __forceinline__ void next() {
    k += dk;
    pos += dp;
    row += dr;
    if (k >= K) {
      k -= K;
      ++pos;
    }
    if (pos >= 3) {
      pos -= 3;
      ++row;
    }
  }
};

// Theta of position pos, index k, at slot s.
__device__ __forceinline__ float& th_at(const Tile& t, int pos, int k, int s) {
  return t.th[(pos * t.K4 + k) * t.NS + s];
}

// Stage p[s], zero the cross-stats and the theta buffer (its pads stay 0).
// The caller syncs before use.
__device__ inline void stage_p(const Tile& t, const float* __restrict__ p_s) {
  const int K = t.K, K4 = t.K4, R = t.R;
  for (int i = threadIdx.x; i < R * K * K4 * K4; i += blockDim.x) {
    const int m = i % K4, l = (i / K4) % K4, rk = i / (K4 * K4);
    const int k = rk % K, r = rk / K;
    t.p_sm[i] = (l < K && m < K) ? p_s[((size_t)(k * K + l) * K + m) * R + r] : 0.f;
    t.cross[i] = 0.f;
  }
  for (int i = threadIdx.x; i < 3 * K4 * t.NS; i += blockDim.x) t.th[i] = 0.f;
}

// Stable order of the tile's n rows by rating: slot[row], wvs, seg; pad
// slots get weight 0 and theta 0.  Enter with rr and wv filled and synced;
// leaves synced.
__device__ inline void sort_rows(const Tile& t, int n) {
  const int tid = threadIdx.x, nt = blockDim.x, R = t.R;
  int* cnt = t.seg + 4;
  if (tid < R) {
    int c = 0;
    for (int j = 0; j < n; ++j) c += t.rr[j] == tid;
    cnt[tid] = c;
  }
  __syncthreads();
  for (int row = tid; row < n; row += nt) {
    const int r = t.rr[row];
    int s = 0;
    for (int q = 0; q < r; ++q) s += (cnt[q] + 3) & ~3;
    for (int j = 0; j < row; ++j) s += t.rr[j] == r;
    t.slot[row] = s;
    t.wvs[s] = t.wv[row];
  }
  for (int i = tid; i < 3 * R; i += nt) {  // up to 3 pad slots a rating
    const int r = i / 3;
    int base = 0;
    for (int q = 0; q < r; ++q) base += (cnt[q] + 3) & ~3;
    const int s = base + cnt[r] + (i - 3 * r);
    if (s < base + ((cnt[r] + 3) & ~3)) {
      t.wvs[s] = 0.f;
      for (int j = 0; j < 3 * t.K4; ++j) t.th[j * t.NS + s] = 0.f;
    }
  }
  if (tid == 0) {
    int a = 0;
    for (int r = 0; r < R; ++r) {
      t.seg[r] = a;
      a += (cnt[r] + 3) & ~3;
    }
    t.seg[R] = a;
  }
  __syncthreads();
}

// Row metadata and theta rows of the tile's n rows from row0, all three
// positions gathered from theta[s] (th_s) into their slots.  Rows past n,
// and rows whose gene id or rating is out of range (the callers check ids
// on the host and raise; this only keeps memory safe), are inert: gene 0,
// rating 0, weight 0.  Leaves synced.
__device__ inline void load_rows(const Tile& t, const int* __restrict__ trip,
                                 const int* __restrict__ rat,
                                 const float* __restrict__ w,
                                 const float* __restrict__ th_s, int row0, int n,
                                 int G) {
  const int K = t.K, RS = t.RS;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < t.tile; i += nt) {
    const int b = row0 + i;
    int g1 = 0, g2 = 0, g3 = 0, r = 0;
    bool valid = i < n;
    if (valid) {
      g1 = trip[3 * b];
      g2 = trip[3 * b + 1];
      g3 = trip[3 * b + 2];
      r = rat[b];
      valid = (unsigned)g1 < (unsigned)G && (unsigned)g2 < (unsigned)G &&
              (unsigned)g3 < (unsigned)G && (unsigned)r < (unsigned)t.R;
    }
    t.gene[i] = valid ? g1 : 0;
    t.gene[RS + i] = valid ? g2 : 0;
    t.gene[2 * RS + i] = valid ? g3 : 0;
    t.rr[i] = valid ? r : 0;
    t.wv[i] = valid ? w[b] : 0.f;
  }
  __syncthreads();
  sort_rows(t, n);
  Walk3 it(tid, nt, K);
  for (int i = tid; i < 3 * K * n; i += nt, it.next())
    th_at(t, it.pos, it.k, t.slot[it.row]) =
        th_s[(size_t)t.gene[it.pos * RS + it.row] * K + it.k];
  __syncthreads();
}

// The rating of slot quad s0 (s0 a multiple of 4).
__device__ __forceinline__ int rating_of(const Tile& t, int s0) {
  int r = 0;
  while (r + 1 < t.R && s0 >= t.seg[r + 1]) ++r;
  return r;
}

// T, A1..A3, D and scale = w/D for the tile's sorted slots (a tile cut
// short by a gene block's end costs only its rows' quads).  Enter with th,
// wvs and seg filled and synced; returns this thread's share of sum w log D;
// leaves with A and scale synced.
__device__ inline float estep(const Tile& t, int n) {
  const int K = t.K, K4 = t.K4, NS = t.NS, LQ = t.K4 >> 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int used = t.seg[t.R], nq = used >> 2;
  const float* th1 = t.th;
  const float* th2 = th1 + K4 * NS;
  const float* th3 = th2 + K4 * NS;
  float* A1 = t.A;
  float* A2 = t.A + K * NS;
  float* A3 = t.A + 2 * K * NS;

  // T[k][l0..l0+3] of slots s0..s0+3: items (quad, l quad, k)
  for (int i = tid; i < nq * LQ * K; i += nt) {
    const int q = i % nq, rest = i / nq;
    const int lq = rest % LQ, k = rest / LQ, s0 = 4 * q;
    const float* pr = t.p_sm + ((rating_of(t, s0) * K + k) * K4 + 4 * lq) * K4;
    float c[4][4];  // [l][slot]
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) c[a][b] = 0.f;
    for (int m0 = 0; m0 < K4; m0 += 4) {
      float x[4][4], y[4][4];  // x[m][slot], y[l][m]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(th3 + (m0 + j) * NS + s0);
        x[j][0] = v.x; x[j][1] = v.y; x[j][2] = v.z; x[j][3] = v.w;
        const float4 u = *reinterpret_cast<const float4*>(pr + j * K4 + m0);
        y[j][0] = u.x; y[j][1] = u.y; y[j][2] = u.z; y[j][3] = u.w;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int b = 0; b < 4; ++b) c[a][b] += y[a][j] * x[j][b];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int l = 4 * lq + a;
      if (l < K)
        *reinterpret_cast<float4*>(t.TV + (k * K + l) * NS + s0) =
            make_float4(c[a][0], c[a][1], c[a][2], c[a][3]);
    }
  }
  __syncthreads();

  // A1[j] = sum_l th2[l] T[j,l];  A2[j] = sum_k th1[k] T[k,j]
  for (int i = tid; i < used * K; i += nt) {
    const int s = i % used, j = i / used;
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < K; ++k) {
      a1 += th2[k * NS + s] * t.TV[(j * K + k) * NS + s];
      a2 += th1[k * NS + s] * t.TV[(k * K + j) * NS + s];
    }
    A1[j * NS + s] = a1;
    A2[j * NS + s] = a2;
  }
  __syncthreads();

  // U[k][m0..m0+3] of slots s0..s0+3: items (quad, m quad, k)
  for (int i = tid; i < nq * LQ * K; i += nt) {
    const int q = i % nq, rest = i / nq;
    const int mq = rest % LQ, k = rest / LQ, s0 = 4 * q;
    const float* pr = t.p_sm + (rating_of(t, s0) * K + k) * K4 * K4 + 4 * mq;
    float c[4][4];  // [m][slot]
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) c[a][b] = 0.f;
#pragma unroll 2
    for (int l = 0; l < K; ++l) {
      const float4 v = *reinterpret_cast<const float4*>(th2 + l * NS + s0);
      const float4 u = *reinterpret_cast<const float4*>(pr + l * K4);
      const float x[4] = {v.x, v.y, v.z, v.w};
      const float y[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) c[a][b] += y[a] * x[b];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int m = 4 * mq + a;
      if (m < K)
        *reinterpret_cast<float4*>(t.TV + (k * K + m) * NS + s0) =
            make_float4(c[a][0], c[a][1], c[a][2], c[a][3]);
    }
  }
  __syncthreads();

  // A3[j] = sum_k th1[k] U[k,j];  D = sum_k th1[k] A1[k];  scale = w / D
  for (int i = tid; i < used * K; i += nt) {
    const int s = i % used, j = i / used;
    float a3 = 0.f;
    for (int k = 0; k < K; ++k) a3 += th1[k * NS + s] * t.TV[(k * K + j) * NS + s];
    A3[j * NS + s] = a3;
  }
  float ll = 0.f;
  for (int s = tid; s < used; s += nt) {
    float d = 0.f;
    for (int k = 0; k < K; ++k) d += th1[k * NS + s] * A1[k * NS + s];
    const float wi = t.wvs[s];
    t.scale[s] = wi / (d + kEps);
    ll += wi * logf(d + kEps);
  }
  __syncthreads();
  return ll;
}

// The marginal of position pos (0..2), component k, of tile row `row`.
__device__ __forceinline__ float marginal(const Tile& t, int pos, int k, int row) {
  const int s = t.slot[row];
  return th_at(t, pos, k, s) * t.A[(pos * t.K + k) * t.NS + s] * t.scale[s];
}

// cross[r][k,l,m] += sum over rating r's slots of th1[k] scale th2[l] th3[m]:
// items (m quad, l quad, k, r), each over its rating's slots only.  Reads
// th, scale and seg; leaves synced.
__device__ inline void cross_acc(const Tile& t, int n) {
  const int K = t.K, K4 = t.K4, NS = t.NS, LQ = t.K4 >> 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* th1 = t.th;
  const float* th2 = th1 + K4 * NS;
  const float* th3 = th2 + K4 * NS;
  for (int i = tid; i < t.R * K * LQ * LQ; i += nt) {
    const int mq = i % LQ, rest = i / LQ;
    const int lq = rest % LQ, rk = rest / LQ;
    const int k = rk % K, r = rk / K;
    const int s_end = t.seg[r + 1];
    if (t.seg[r] == s_end) continue;
    float acc[4][4];  // [l][m]
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int s0 = t.seg[r]; s0 < s_end; s0 += 4) {
      const float4 v1 = *reinterpret_cast<const float4*>(th1 + k * NS + s0);
      const float4 sc = *reinterpret_cast<const float4*>(t.scale + s0);
      const float c[4] = {v1.x * sc.x, v1.y * sc.y, v1.z * sc.z, v1.w * sc.w};
      float x[4][4], y[4][4];  // [l][slot], [m][slot]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 u = *reinterpret_cast<const float4*>(th2 + (4 * lq + j) * NS + s0);
        x[j][0] = c[0] * u.x; x[j][1] = c[1] * u.y; x[j][2] = c[2] * u.z; x[j][3] = c[3] * u.w;
        const float4 v = *reinterpret_cast<const float4*>(th3 + (4 * mq + j) * NS + s0);
        y[j][0] = v.x; y[j][1] = v.y; y[j][2] = v.z; y[j][3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += x[a][e] * y[b][e];
    }
    float* cr = t.cross + ((r * K + k) * K4 + 4 * lq) * K4 + 4 * mq;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float4* c4 = reinterpret_cast<float4*>(cr + a * K4);
      float4 v = *c4;
      v.x += acc[a][0];
      v.y += acc[a][1];
      v.z += acc[a][2];
      v.w += acc[a][3];
      *c4 = v;
    }
  }
  __syncthreads();
}

// Store the sum of every thread's v into *dst: warp sums, then the warps'
// sums in warp order, by thread 0 (a fixed order).
__device__ inline void block_store(float v, float* __restrict__ dst) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __shared__ float red[32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    float w = tid < (nt + 31) / 32 ? red[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      w += __shfl_down_sync(0xffffffffu, w, off);
    if (tid == 0) *dst = w;
  }
}

// Write the block's p-stats p * cross into pp, its [K, K, K, R] slot of the
// partial buffer (every cell), and its sum w log D into *lp.
__device__ inline void flush_part(const Tile& t, float* __restrict__ pp,
                                  float ll_acc, float* __restrict__ lp) {
  const int K = t.K, K4 = t.K4, R = t.R;
  for (int c = threadIdx.x; c < R * K * K4 * K4; c += blockDim.x) {
    const int m = c % K4, l = (c / K4) % K4, rk = c / (K4 * K4);
    const int k = rk % K, r = rk / K;
    if (l < K && m < K) pp[((size_t)(k * K + l) * K + m) * R + r] = t.p_sm[c] * t.cross[c];
  }
  block_store(ll_acc, lp);
}

// The warp whose bucket holds a key: a multiplicative hash's top bits.
__device__ __forceinline__ int bucket_of(int key) {
  return (int)(((unsigned)key * 2654435761u) >> (32 - kBucketBits));
}

// For every distinct key of the tile's E <= 3 tile entries (key[e] >= 0 in
// t.link; -1: e takes no part; filled and synced by the caller, after
// estep()), *dst(key, k) += the sum over the key's entries, in entry order,
// of marg(e, k), for k < K, with one writer per (key, k), so dst may be a
// block's private accumulator.  No atomics and one barrier (the caller's):
// - each warp takes the keys that hash to it: it walks the entries 32 at
//   a time and compacts its own by ballot, in entry order (no two warps
//   share a key, so none write one element);
// - per round of 32 of its entries, __match_any_sync groups them by key,
//   and the items (group, k), group-major, are spread over the warp's
//   lanes: a lane sums its group's entries in lane (= entry) order and does
//   the read-modify-write, eight in flight.  A key's later rounds follow in
//   the same warp, after a __syncwarp.
// The caller syncs before the next call.
template <typename Marg, typename Dst>
__device__ inline void keyed_sum(const Tile& t, int E, int K, Marg marg, Dst dst) {
  constexpr int kInFlight = 8;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* key = t.link;
  int* mine = t.link + 3 * t.tile * (1 + warp);               // [3 tile] this warp's entries
  int* glane = t.link + 3 * t.tile * (1 + kBuckets) + 32 * warp;  // [32] group -> lane
  int n = 0;
  for (int r = 0; r < E; r += 32) {
    const int e = r + lane;
    const int ke = e < E ? key[e] : -1;
    const bool in = ke >= 0 && bucket_of(ke) == warp;
    const unsigned bal = __ballot_sync(kAll, in);
    if (in) mine[n + __popc(bal & ((1u << lane) - 1))] = e;
    n += __popc(bal);
  }
  __syncwarp();
  for (int r = 0; r < n; r += 32) {
    const int e = r + lane < n ? mine[r + lane] : -1;
    const int kk = e >= 0 ? key[e] : -1 - lane;  // lanes past the list: alone
    const unsigned grp = __match_any_sync(kAll, kk);
    const bool leads = e >= 0 && __ffs(grp) - 1 == lane;
    const unsigned lead = __ballot_sync(kAll, leads);
    if (leads) glane[__popc(lead & ((1u << lane) - 1))] = lane;
    __syncwarp();
    const int items = __popc(lead) * K;
    for (int i0 = 0; i0 < items; i0 += 32 * kInFlight) {
      float sum[kInFlight], old[kInFlight];
      float* to[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + 32 * u + lane;
        const int gi = i / K, k = i - gi * K;
        const int src = i < items ? glane[gi] : 0;
        const unsigned g = __shfl_sync(kAll, grp, src);
        const int kg = __shfl_sync(kAll, kk, src);
        to[u] = nullptr;
        sum[u] = 0.f;
        if (i < items) {
          float v = 0.f;
          for (unsigned m = g; m; m &= m - 1) v += marg(mine[r + __ffs(m) - 1], k);
          sum[u] = v;
          to[u] = dst(kg, k);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) old[u] = to[u] ? *to[u] : 0.f;
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (to[u]) *to[u] = old[u] + sum[u];
    }
    __syncwarp();  // this round's writes and glane before the next round's
  }
}

// part[gene * K + k] += the tile's marginals of that gene at index k
// (entries e = 3 row + pos, rows of nonzero weight), each gene's summed in
// entry order by keyed_sum: part may be a block's private theta_hat in
// global memory.  Reads th, A, scale, gene, wv; the caller syncs before the
// next tile.
__device__ inline void add_marginals(const Tile& t, int n, float* part) {
  const int K = t.K, RS = t.RS, E = 3 * n;
  int* key = t.link;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int row = e / 3, pos = e - 3 * row;
    key[e] = t.wv[row] != 0.f ? t.gene[pos * RS + row] : -1;
  }
  __syncthreads();
  keyed_sum(
      t, E, K,
      [&](int e, int k) {
        const int row = e / 3;
        return marginal(t, e - 3 * row, k, row);
      },
      [&](int key, int k) { return part + (size_t)key * K + k; });
}

}  // namespace tip
