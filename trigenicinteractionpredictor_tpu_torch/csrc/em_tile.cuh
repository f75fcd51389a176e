// The row-tile algebra of the E-step kernels: K1 (em_sweep.cu) and the
// large-G kernels (em_streams.cu, em_bdg.cu).  Each kernel gathers its rows'
// theta and places the per-row position marginals its own way (K1 scatters
// them into theta_hat, the others write streams or a block accumulator).
//
// One block owns one restart s; p[s] and its cross-stats stay in shared
// memory for the block's whole run of rows.  Per tile of `tile` rows the
// caller fills the row metadata (gene, rr, wv) and the gathered theta rows
// (th), then calls estep(), places the marginals th * A * scale, and calls
// cross_acc().  Per-row vectors are [component][row] with row stride
// RS = tile + 1 (conflict-free).  Exact float32: no tensor cores, no TF32.

#pragma once

#include <cuda_runtime.h>

namespace tip {

constexpr float kEps = 1e-30f;

struct Tile {
  int K, R, tile, RS;
  float* p_sm;   // [R][K][K2]: p[s,k,l,m,r] at (r*K+m)*K2 + k*K+l
  float* cross;  // [R][K2][K]: cell (r*K2 + k*K+l)*K + m
  float* TV;     // [K2][RS]: T, then V = th1 th2 w/D
  float* th;     // [3][K][RS]: theta rows per position
  float* A;      // [3][K][RS]: A1, A2, A3
  float* wv;     // [RS]
  float* scale;  // [RS]
  int* gene;     // [3][RS]
  int* rr;       // [RS]
  float* rest;   // the first float past these buffers (kernel's own use)
};

// The buffers above, carved from the dynamic shared memory in this order:
// 2 R K^3 + K^2 RS + 6 K RS + 2 RS floats and 4 RS ints, which the host
// plans (ops/em_bdr.py sweep_plan, ops/em_bdg.py _smem_bytes) mirror.
__device__ inline Tile carve(float* smem, int K, int R, int tile) {
  Tile t;
  t.K = K;
  t.R = R;
  t.tile = tile;
  t.RS = tile + 1;
  const int K3 = K * K * K, RS = t.RS;
  t.p_sm = smem;
  t.cross = t.p_sm + R * K3;
  t.TV = t.cross + R * K3;
  t.th = t.TV + K * K * RS;
  t.A = t.th + 3 * K * RS;
  t.wv = t.A + 3 * K * RS;
  t.scale = t.wv + RS;
  t.gene = reinterpret_cast<int*>(t.scale + RS);
  t.rr = t.gene + 3 * RS;
  t.rest = reinterpret_cast<float*>(t.rr + RS);
  return t;
}

// Stage p[s] and zero the cross-stats.  The caller syncs before use.
__device__ inline void stage_p(const Tile& t, const float* __restrict__ p_s) {
  const int K = t.K, K2 = K * K, K3 = K2 * K;
  for (int i = threadIdx.x; i < K3 * t.R; i += blockDim.x) {
    const int r = i % t.R, klm = i / t.R;
    const int m = klm % K, kl = klm / K;
    t.p_sm[(r * K + m) * K2 + kl] = p_s[i];
    t.cross[i] = 0.f;
  }
}

// Row metadata and theta rows of the tile's n rows from row0, all three
// positions gathered from theta[s] (th_s).  Rows past n, and rows whose
// gene id or rating is out of range (the callers check ids on the host and
// raise; this only keeps memory safe), are inert: gene 0, rating 0,
// weight 0.  Leaves synced.
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
  for (int i = tid; i < 3 * K * n; i += nt) {
    const int row = i % n, j = i / n;  // j = pos*K + k
    const int k = j % K, pos = j / K;
    t.th[j * RS + row] = th_s[(size_t)t.gene[pos * RS + row] * K + k];
  }
  __syncthreads();
}

// T, A1..A3, D and scale = w/D for the tile's first n rows (a tile cut
// short by a gene block's end costs only its rows).  Enter with th, rr and
// wv filled and synced; returns this thread's share of sum w log D; leaves
// with A and scale synced.
__device__ inline float estep(const Tile& t, int n) {
  const int K = t.K, K2 = K * K, RS = t.RS;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* th1 = t.th;
  const float* th2 = t.th + K * RS;
  const float* th3 = t.th + 2 * K * RS;
  float* A1 = t.A;
  float* A2 = t.A + K * RS;
  float* A3 = t.A + 2 * K * RS;

  // T[k,l] = sum_m th3[m] p[k,l,m,r]
  for (int i = tid; i < K2 * n; i += nt) {
    const int row = i % n, kl = i / n;
    const float* pr = t.p_sm + t.rr[row] * K * K2 + kl;
    float acc = 0.f;
    for (int m = 0; m < K; ++m) acc += th3[m * RS + row] * pr[m * K2];
    t.TV[kl * RS + row] = acc;
  }
  __syncthreads();

  // A1[j] = sum_l th2[l] T[j,l];  A2[j] = sum_k th1[k] T[k,j];
  // A3[j] = sum_kl th1[k] th2[l] p[k,l,j,r]
  for (int i = tid; i < K * n; i += nt) {
    const int row = i % n, j = i / n;
    const float* pr = t.p_sm + (t.rr[row] * K + j) * K2;
    float a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int k = 0; k < K; ++k) {
      const float t1 = th1[k * RS + row];
      a1 += th2[k * RS + row] * t.TV[(j * K + k) * RS + row];
      a2 += t1 * t.TV[(k * K + j) * RS + row];
      float acc = 0.f;
      for (int l = 0; l < K; ++l) acc += th2[l * RS + row] * pr[k * K + l];
      a3 += t1 * acc;
    }
    A1[j * RS + row] = a1;
    A2[j * RS + row] = a2;
    A3[j * RS + row] = a3;
  }
  __syncthreads();

  // D = sum_k th1[k] A1[k];  scale = w / D;  L += w log D
  float ll = 0.f;
  for (int i = tid; i < n; i += nt) {
    float d = 0.f;
    for (int k = 0; k < K; ++k) d += th1[k * RS + i] * A1[k * RS + i];
    const float wi = t.wv[i];
    t.scale[i] = wi / (d + kEps);
    ll += wi * logf(d + kEps);
  }
  __syncthreads();
  return ll;
}

// The marginal of position pos (0..2), component k, of tile row `row`.
__device__ inline float marginal(const Tile& t, int pos, int k, int row) {
  const int j = (pos * t.K + k) * t.RS + row;
  return t.th[j] * t.A[j] * t.scale[row];
}

// V = th1 th2 scale, then cross[r][k,l][m] += sum over the tile's n rows of
// rating r of V[k,l] th3[m].  Reads th, scale and rr; overwrites TV (T is
// spent once A is); leaves synced.
__device__ inline void cross_acc(const Tile& t, int n) {
  const int K = t.K, K2 = K * K, K3 = K2 * K, RS = t.RS;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* th1 = t.th;
  const float* th2 = t.th + K * RS;
  const float* th3 = t.th + 2 * K * RS;
  for (int i = tid; i < K2 * n; i += nt) {
    const int row = i % n, kl = i / n;
    t.TV[kl * RS + row] =
        th1[(kl / K) * RS + row] * th2[(kl % K) * RS + row] * t.scale[row];
  }
  __syncthreads();
  for (int c = tid; c < t.R * K3; c += nt) {
    const int m = c % K, rest = c / K;
    const int kl = rest % K2, r = rest / K2;
    float acc = 0.f;
    for (int row = 0; row < n; ++row)
      acc += t.rr[row] == r ? t.TV[kl * RS + row] * th3[m * RS + row] : 0.f;
    t.cross[c] += acc;
  }
  __syncthreads();
}

// Flush the block's p-stats into p_hat[s] as p * cross (one atomic per
// nonzero cell), and its sum w log D into ll[s] (one atomic per block).
__device__ inline void flush(const Tile& t, float* __restrict__ ph_s,
                             float ll_acc, float* __restrict__ ll_s) {
  const int K = t.K, K2 = K * K, K3 = K2 * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int c = tid; c < t.R * K3; c += nt) {
    const float v = t.cross[c];
    if (v != 0.f) {
      const int m = c % K, rest = c / K;
      const int kl = rest % K2, r = rest / K2;
      atomicAdd(&ph_s[(kl * K + m) * t.R + r], t.p_sm[(r * K + m) * K2 + kl] * v);
    }
  }
  __shared__ float red[32];
  for (int off = 16; off > 0; off >>= 1)
    ll_acc += __shfl_down_sync(0xffffffffu, ll_acc, off);
  if ((tid & 31) == 0) red[tid >> 5] = ll_acc;
  __syncthreads();
  if (tid < 32) {
    float v = tid < (nt + 31) / 32 ? red[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (tid == 0) atomicAdd(ll_s, v);
  }
}

}  // namespace tip
