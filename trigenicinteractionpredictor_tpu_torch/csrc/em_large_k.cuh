// The large-K sweep algebra (21 <= K <= 72) shared by K3
// (csrc/em_sweep_large_k.cu) and K7 (csrc/em_hybrid.cu).  The two kernels
// differ only in where a row's theta values come from, which is the Rows
// template parameter of both passes:
//   GatherRows  -- theta[s, gene, :] read through the row's gene id (K3);
//   StreamRows  -- pre-gathered streams th_pos[b, s*K + k] (K7).
// Everything else -- the per-row algebra, the theta_hat scatter by gene id
// and the cross-stat pass -- is one code path.
//
// Pass 1 (estep_kernel), grid (row tiles, S), 256 threads = 8 warps: a
// block owns one restart and a tile of 64 rows, sorted by rating in shared
// memory, 8 rows per warp, taken in pairs.  It walks p[s] one k-slice
// p[s,k,:,:,:] (K^2 R floats, 20 KB at K = 50, R = 2) at a time through
// shared memory.  In the warp of a row, lane j (and j + 32 when K > 32,
// j + 64 when K > 64) plays index j:
//     T[k,j] = sum_m th3[m] p[k,j,m,r]      U[k,j] = sum_l th2[l] p[k,l,j,r]
//     A2[j] += th1[k] T[k,j]                A3[j] += th1[k] U[k,j]
//     A1[k]  = sum_j th2[j] T[k,j]          (a warp butterfly sum)
//     D     += th1[k] A1[k]
// so after one pass over the slices each row has A1, A2, A3 and D in
// registers.  It then scatters th_pos * A_pos * w/D into theta_hat (3 K
// global atomics per row and restart), adds w log D to loglik (one atomic
// per block) and writes scale = w/D to an [S, B] buffer.
//
// Pass 2 (cross_kernel), grid (K, S, row splits): a block owns the output
// slice cross[s,k,:,:,:] (K^2 R cells) and streams its split of the rows,
// reading the per-row scale of pass 1:
//     cross[k,l,m,r_b] += th1[b,k] scale_b th2[b,l] th3[b,m]
// Each thread holds a 4 x 4 (l, m) register tile of one rating and adds
// only rows of that rating.  A block flushes p * cross once with atomics
// (at most S K^3 R splits atomics per sweep), so there are no per-tile
// atomics on p_hat.
//
// What bounds it on the H100: ~3 K^3 multiply-adds per row and restart.
// The loops of pass 1 are bound by shared-memory bandwidth: a lane needs a
// p value of its own and a theta value shared by the warp for each
// multiply-add.  A pair of rows of one rating reads each p value once for
// both rows, and theta comes as float4 broadcasts, so a warp issues ~0.6
// shared-memory wavefronts per multiply-add at K > 32 (2 for one row at a
// time with scalar theta).  Pass 2 reuses each staged theta value four
// times.  Exact float32: no tensor cores, no TF32.
//
// Weight-0 rows, and rows with an out-of-range gene id or rating (the
// callers check ids on the host and raise; this only keeps memory safe),
// are inert: they add nothing to any output.  Rows past B read nothing.

#pragma once

#include <cuda_runtime.h>

namespace large_k {
namespace {  // internal linkage: each kernel source instantiates its own

constexpr float kEps = 1e-30f;
constexpr int kWarps = 8;          // pass 1: warps per block
constexpr int kRowsPerWarp = 8;    // pass 1: rows per warp
constexpr int kTile = kWarps * kRowsPerWarp;  // pass 1: rows per block
constexpr int kTile2 = 64;         // pass 2: rows staged per step

// A row source hands each pass one restart's view (at), hoisting the
// restart's offset out of the loops; the view returns the theta value of
// row b (gene id `gene`) at position pos and index k.
//
// theta[s, gene, k] through the row's gene id (G genes per restart).
struct GatherRows {
  const float* theta;  // [S, G, K]
  int G;
  struct Restart {
    const float* th;   // theta[s]
    __device__ __forceinline__ float operator()(int pos, int b, int gene, int k,
                                                int K) const {
      return th[(size_t)gene * K + k];
    }
  };
  __device__ __forceinline__ Restart at(int s, int K) const {
    return Restart{theta + (size_t)s * G * K};
  }
};

// th_pos[b, s*K + k] from the pre-gathered streams (S restarts per row).
struct StreamRows {
  const float* th1;  // [B, S*K]
  const float* th2;
  const float* th3;
  int S;
  struct Restart {
    const float* t1;   // th_pos + s*K
    const float* t2;
    const float* t3;
    int SK;
    __device__ __forceinline__ float operator()(int pos, int b, int gene, int k,
                                                int K) const {
      const float* t = pos == 0 ? t1 : (pos == 1 ? t2 : t3);
      return t[(size_t)b * SK + k];
    }
  };
  __device__ __forceinline__ Restart at(int s, int K) const {
    return Restart{th1 + s * K, th2 + s * K, th3 + s * K, S * K};
  }
};

// T and U of one k-slice for a pair of rows (a, b), lane j = lane + 32 jj:
//     T[j] = sum_m th3[m] X[j][m]        U[j] = sum_l th2[l] X[l][j]
// X_a, X_b are the slices of the rows' ratings; kSame (the two ratings are
// equal, the common case in a rating-sorted tile) reads each X value once
// for both rows.  theta is read as float4 broadcasts from rows zero-padded
// to ts; X reads past column or row K land on zeroed or finite cells of
// the slice buffer and are multiplied by those zeros.  Lanes with j >= K
// compute on row K - 1 and their results are dropped by the caller.
template <int J, bool kSame>
__device__ __forceinline__ void pair_tu(
    const float* __restrict__ Xa, const float* __restrict__ Xb,
    const float* __restrict__ t2a, const float* __restrict__ t3a,
    const float* __restrict__ t2b, const float* __restrict__ t3b, int K,
    int ts, int xs, int lane, float (&ta)[J], float (&tb)[J], float (&ua)[J],
    float (&ub)[J]) {
  int jc[J];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    jc[jj] = min(lane + 32 * jj, K - 1);
    ta[jj] = tb[jj] = ua[jj] = ub[jj] = 0.f;
  }
  for (int m = 0; m < ts; m += 4) {
    const float4 ha = *reinterpret_cast<const float4*>(t3a + m);
    const float4 hb = *reinterpret_cast<const float4*>(t3b + m);
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float* xa = Xa + jc[jj] * xs + m;
      const float* xb = kSame ? xa : Xb + jc[jj] * xs + m;
      ta[jj] += ha.x * xa[0] + ha.y * xa[1] + ha.z * xa[2] + ha.w * xa[3];
      tb[jj] += hb.x * xb[0] + hb.y * xb[1] + hb.z * xb[2] + hb.w * xb[3];
    }
  }
  for (int l = 0; l < ts; l += 4) {
    const float4 ga = *reinterpret_cast<const float4*>(t2a + l);
    const float4 gb = *reinterpret_cast<const float4*>(t2b + l);
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float* ya = Xa + l * xs + jc[jj];
      const float* yb = kSame ? ya : Xb + l * xs + jc[jj];
      ua[jj] += ga.x * ya[0] + ga.y * ya[xs] + ga.z * ya[2 * xs] + ga.w * ya[3 * xs];
      ub[jj] += gb.x * yb[0] + gb.y * yb[xs] + gb.z * yb[2 * xs] + gb.w * yb[3 * xs];
    }
  }
}

// Pass 1.  J = ceil(K / 32) indices per lane.  The tile's rows are sorted
// by rating (stably), so the rows of a pair mostly share one p slice.  At
// J = 3 a thread holds 9 sums for each of its warp's 8 rows: 181 registers
// of the 255 a thread of a 256-thread block may have, no spill (4 rows a
// warp, 108 registers and two blocks an SM, ran 2% slower on the H100).
// Shared memory (floats; xs = K|1, ts = K rounded up to 4):
//   X     [(R K + 4) xs], rounded up to 4: slice k, p[s,k,l,m,r] at
//         (r*K + l)*xs + m; zeroed once, pads and the 4 spare rows stay 0
//   th    [3][kTile][ts] theta rows of the sorted rows per position, 0 past K
//   wv [kTile]; as ints gene [3][kTile], rr, orig (row in the tile) and
//   rraw (ratings before the sort) [kTile] each
template <int J, typename Rows>
__global__ void __launch_bounds__(kWarps * 32) estep_kernel(
    Rows rows,                        // theta values of a row, see above
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    const int* __restrict__ rat,      // [B]
    const float* __restrict__ w,      // [B]
    float* __restrict__ theta_hat,    // [S, G, K], zeroed by the caller
    float* __restrict__ ll,           // [S], zeroed by the caller
    float* __restrict__ scale_out,    // [S, B]
    int B, int G, int K, int R) {
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int K2 = K * K;
  const int xs = K | 1;  // odd row stride: lane j reading X[j][m] hits bank j
  const int ts = (K + 3) & ~3;
  const int xsize = ((R * K + 4) * xs + 3) & ~3;

  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* th = X + xsize;
  float* wv = th + 3 * kTile * ts;
  int* gene = reinterpret_cast<int*>(wv + kTile);
  int* rr = gene + 3 * kTile;
  int* orig = rr + kTile;
  int* rraw = orig + kTile;
  __shared__ float red[kWarps];

  for (int i = tid; i < xsize; i += nt) X[i] = 0.f;

  // Row metadata.  Rows past the end, and rows whose gene id or rating is
  // out of range, are inert: gene 0, rating 0, weight 0.
  int g1 = 0, g2 = 0, g3 = 0, r = 0;
  float wi = 0.f;
  if (tid < kTile) {
    const int b = row0 + tid;
    if (b < B) {
      g1 = trip[3 * b];
      g2 = trip[3 * b + 1];
      g3 = trip[3 * b + 2];
      r = rat[b];
      if ((unsigned)g1 < (unsigned)G && (unsigned)g2 < (unsigned)G &&
          (unsigned)g3 < (unsigned)G && (unsigned)r < (unsigned)R) {
        wi = w[b];
      } else {
        g1 = g2 = g3 = r = 0;
      }
    }
    rraw[tid] = r;
  }
  __syncthreads();
  if (tid < kTile) {
    int pos = 0;
    for (int j = 0; j < kTile; ++j) {
      const int rj = rraw[j];
      pos += (rj < r) || (rj == r && j < tid);
    }
    gene[pos] = g1;
    gene[kTile + pos] = g2;
    gene[2 * kTile + pos] = g3;
    rr[pos] = r;
    wv[pos] = wi;
    orig[pos] = tid;
  }
  __syncthreads();

  const auto rows_s = rows.at(s, K);
  for (int i = tid; i < 3 * kTile * ts; i += nt) {
    const int k = i % ts, pr = i / ts;  // pr = pos * kTile + row
    const int b = row0 + orig[pr % kTile];
    th[i] = (k < K && b < B) ? rows_s(pr / kTile, b, gene[pr], k, K) : 0.f;
  }

  float a1[kRowsPerWarp][J], a2[kRowsPerWarp][J], a3[kRowsPerWarp][J];
  float d[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    d[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) a1[i][jj] = a2[i][jj] = a3[i][jj] = 0.f;
  }

  const float* p_s = p + (size_t)s * K2 * K * R;
  for (int k = 0; k < K; ++k) {
    __syncthreads();  // the previous slice is consumed (first: rows staged)
    const float* p_k = p_s + (size_t)k * K2 * R;
    for (int i = tid; i < K2 * R; i += nt) {
      const int rr_ = i % R, lm = i / R;
      const int m = lm % K, l = lm / K;
      X[(rr_ * K + l) * xs + m] = p_k[i];
    }
    __syncthreads();

#pragma unroll
    for (int ia = 0; ia < kRowsPerWarp; ia += 2) {
      const int ib = ia + 1;
      const int rowa = warp * kRowsPerWarp + ia, rowb = rowa + 1;
      const int ra = rr[rowa], rb = rr[rowb];
      const float* t2a = th + (kTile + rowa) * ts;
      const float* t2b = th + (kTile + rowb) * ts;
      const float* t3a = th + (2 * kTile + rowa) * ts;
      const float* t3b = th + (2 * kTile + rowb) * ts;
      float ta[J], tb[J], ua[J], ub[J];
      if (ra == rb)
        pair_tu<J, true>(X + ra * K * xs, X + rb * K * xs, t2a, t3a, t2b, t3b,
                         K, ts, xs, lane, ta, tb, ua, ub);
      else
        pair_tu<J, false>(X + ra * K * xs, X + rb * K * xs, t2a, t3a, t2b, t3b,
                          K, ts, xs, lane, ta, tb, ua, ub);
      const float t1a = th[rowa * ts + k], t1b = th[rowb * ts + k];
      float qa = 0.f, qb = 0.f;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const int j = lane + 32 * jj;
        if (j < K) {
          a2[ia][jj] += t1a * ta[jj];
          a3[ia][jj] += t1a * ua[jj];
          a2[ib][jj] += t1b * tb[jj];
          a3[ib][jj] += t1b * ub[jj];
          qa += t2a[j] * ta[jj];
          qb += t2b[j] * tb[jj];
        }
      }
      // A1[k] = sum_j th2[j] T[k,j]: butterfly sums over the warp
      for (int off = 16; off > 0; off >>= 1) {
        qa += __shfl_xor_sync(0xffffffffu, qa, off);
        qb += __shfl_xor_sync(0xffffffffu, qb, off);
      }
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (k == lane + 32 * jj) {
          a1[ia][jj] = qa;
          a1[ib][jj] = qb;
        }
      }
      d[ia] += t1a * qa;
      d[ib] += t1b * qb;
    }
  }

  float* thh_s = theta_hat + (size_t)s * G * K;
  float ll_acc = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = warp * kRowsPerWarp + i;
    const float wr = wv[row];
    const float sc = wr / (d[i] + kEps);
    if (lane == 0) {
      ll_acc += wr * logf(d[i] + kEps);
      const int b = row0 + orig[row];
      if (b < B) scale_out[(size_t)s * B + b] = sc;
    }
    if (wr != 0.f) {
      const float* t1 = th + row * ts;
      const float* t2 = th + (kTile + row) * ts;
      const float* t3 = th + (2 * kTile + row) * ts;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const int j = lane + 32 * jj;
        if (j < K) {
          atomicAdd(&thh_s[(size_t)gene[row] * K + j], t1[j] * a1[i][jj] * sc);
          atomicAdd(&thh_s[(size_t)gene[kTile + row] * K + j],
                    t2[j] * a2[i][jj] * sc);
          atomicAdd(&thh_s[(size_t)gene[2 * kTile + row] * K + j],
                    t3[j] * a3[i][jj] * sc);
        }
      }
    }
  }
  if (lane == 0) red[warp] = ll_acc;
  __syncthreads();
  if (tid == 0) {
    float v = 0.f;
    for (int i = 0; i < kWarps; ++i) v += red[i];
    atomicAdd(&ll[s], v);
  }
}

// Pass 2.  blockDim.x >= R * LQ^2 with LQ = ceil(K / 4): thread t owns
// rating t / LQ^2 and the 4 x 4 cell tile (4 lq.., 4 mq..) of slice k.
// Shared memory (floats, KP = 4 LQ, zero-padded past K):
//   th2, th3 [kTile2][KP]; c [kTile2]; as ints rr, the two gene ids and
//   the row index b [kTile2] each
template <typename Rows>
__global__ void cross_kernel(
    Rows rows,                        // theta values of a row, see above
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    const int* __restrict__ rat,      // [B]
    const float* __restrict__ scale,  // [S, B] from pass 1
    float* __restrict__ p_hat,        // [S, K, K, K, R], zeroed by the caller
    int B, int G, int K, int R, int rows_per_split) {
  const int k = blockIdx.x, s = blockIdx.y;
  const int b_begin = blockIdx.z * rows_per_split;
  const int b_end = min(B, b_begin + rows_per_split);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int LQ = (K + 3) / 4, KP = 4 * LQ;
  const bool active = tid < R * LQ * LQ;
  const int my_r = active ? tid / (LQ * LQ) : -1;
  const int lq = (tid % (LQ * LQ)) / LQ, mq = tid % LQ;

  extern __shared__ float4 smem4[];
  float* th2 = reinterpret_cast<float*>(smem4);
  float* th3 = th2 + kTile2 * KP;
  float* c = th3 + kTile2 * KP;
  int* rr = reinterpret_cast<int*>(c + kTile2);
  int* g23 = rr + kTile2;      // [2][kTile2]
  int* bb = g23 + 2 * kTile2;  // [kTile2]

  const auto rows_s = rows.at(s, K);
  const float* sc_s = scale + (size_t)s * B;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int row0 = b_begin; row0 < b_end; row0 += kTile2) {
    const int n = min(kTile2, b_end - row0);
    __syncthreads();  // the previous step's rows are consumed
    for (int i = tid; i < kTile2; i += nt) {
      const int b = row0 + i;
      int g1 = 0, g2 = 0, g3 = 0, r = -1;
      float ci = 0.f;
      if (i < n) {
        g1 = trip[3 * b];
        g2 = trip[3 * b + 1];
        g3 = trip[3 * b + 2];
        r = rat[b];
        const bool valid =
            (unsigned)g1 < (unsigned)G && (unsigned)g2 < (unsigned)G &&
            (unsigned)g3 < (unsigned)G && (unsigned)r < (unsigned)R;
        if (valid) ci = rows_s(0, b, g1, k, K) * sc_s[b];
        if (!valid || ci == 0.f) {  // inert: skipped below
          g2 = g3 = 0;
          r = -1;
        }
      }
      c[i] = ci;
      rr[i] = r;
      g23[i] = g2;
      g23[kTile2 + i] = g3;
      bb[i] = b;
    }
    __syncthreads();
    for (int i = tid; i < kTile2 * KP; i += nt) {
      const int row = i / KP, m = i % KP;
      float v2 = 0.f, v3 = 0.f;
      if (m < K && rr[row] >= 0) {
        v2 = rows_s(1, bb[row], g23[row], m, K);
        v3 = rows_s(2, bb[row], g23[kTile2 + row], m, K);
      }
      th2[i] = v2;
      th3[i] = v3;
    }
    __syncthreads();
    if (active) {
      // Sum the step's rows apart, then add to the run's total: a cell sums
      // up to B rows, and one running float32 sum over all of them loses
      // ~n ulps where this two-level sum loses ~(kTile2 + n / kTile2).
      float part[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) part[a][b] = 0.f;
      for (int row = 0; row < n; ++row) {
        if (rr[row] != my_r) continue;
        const float ci = c[row];
        const float4 a4 = *reinterpret_cast<const float4*>(th2 + row * KP + 4 * lq);
        const float4 b4 = *reinterpret_cast<const float4*>(th3 + row * KP + 4 * mq);
        const float av[4] = {ci * a4.x, ci * a4.y, ci * a4.z, ci * a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) part[a][b] += av[a] * bv[b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += part[a][b];
    }
  }

  if (active) {
    const size_t base = ((size_t)s * K + k) * K;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int l = 4 * lq + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int m = 4 * mq + b;
        if (l < K && m < K && acc[a][b] != 0.f) {
          const size_t idx = ((base + l) * K + m) * R + my_r;
          atomicAdd(&p_hat[idx], p[idx] * acc[a][b]);
        }
      }
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// Pass 1 for J indices per lane.
template <int J, typename Rows>
int launch_estep(Rows rows, const void* p, const void* trip, const void* rat,
                 const void* w, void* theta_hat, void* ll, void* scale, int S,
                 int B, int G, int K, int R, int estep_smem, cudaStream_t st) {
  if (int err = set_smem(estep_kernel<J, Rows>, estep_smem)) return err;
  estep_kernel<J, Rows><<<dim3((B + kTile - 1) / kTile, S), kWarps * 32, estep_smem, st>>>(
      rows, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)w, (float*)theta_hat, (float*)ll, (float*)scale, B, G, K,
      R);
  return (int)cudaGetLastError();
}

// Launch both passes on `stream`; returns cudaGetLastError() (0 on
// success).  The caller zeroes theta_hat, p_hat and ll, allocates scale
// [S, B], and sizes the shared memory and pass-2 threads from the host
// plan (ops/em_large_k.py sweep_plan).
template <typename Rows>
int launch(Rows rows, const void* p, const void* trip, const void* rat,
           const void* w, void* theta_hat, void* p_hat, void* ll, void* scale,
           int S, int B, int G, int K, int R, int splits, int estep_smem,
           int cross_threads, int cross_smem, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (K > 64)
    err = launch_estep<3>(rows, p, trip, rat, w, theta_hat, ll, scale, S, B, G,
                          K, R, estep_smem, st);
  else if (K > 32)
    err = launch_estep<2>(rows, p, trip, rat, w, theta_hat, ll, scale, S, B, G,
                          K, R, estep_smem, st);
  else
    err = launch_estep<1>(rows, p, trip, rat, w, theta_hat, ll, scale, S, B, G,
                          K, R, estep_smem, st);
  if (err) return err;
  if ((err = set_smem(cross_kernel<Rows>, cross_smem))) return err;
  const int rows_per_split = (B + splits - 1) / splits;
  const dim3 grid2(K, S, splits);
  cross_kernel<Rows><<<grid2, cross_threads, cross_smem, st>>>(
      rows, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)scale, (float*)p_hat, B, G, K, R, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace large_k
