// K1: the whole-ensemble EM sweep (E-step + M-accumulate) for the trigenic
// MMSBM, hand-written for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_bdr.py,
//   _em_tile_kernel_bdr (launched by _pallas_stats_bdr).  Same contract:
//   theta_hat [S,G,K], p_hat = p * cross [S,K,K,K,R] and loglik [S] of the
//   pre-update state, equal to the batched plain sweep of ops/em.py.  The
//   TPU kernel's one-hot gather/scatter matmuls and block-diagonal operands
//   served only the TPU's matrix unit and are not carried over; this kernel
//   reads each row's rating itself, so rows need no rating sort.
//
// Supported shapes: 1 <= K <= 20 for R <= 3 (the host plan in
// ops/em_bdr.py checks the shared-memory budget and refuses anything
// larger); any G (no cap: theta rows are read from global memory); any
// S <= 65535; any B >= 1.
//
// What bounds it on the H100: per row and restart the sweep does ~3 K^3
// multiply-adds (T, A3 and the p cross-stats) against K^3 R values of
// p[s], plus 3 K scattered atomic adds into theta_hat.  At K = 10 that is
// far below the card's float32 rate and its HBM bandwidth: theta (400 KB
// at G = 1000, S = 10) and p stay L2-resident, so the limits are shared-
// memory traffic of the K^3 loops and the L2 atomics of the theta_hat
// scatter.
//
// Design:
// - grid (row blocks, S): a block owns one restart s and a contiguous run
//   of rows, walked in tiles of `tile` rows;
// - p[s] is staged once in shared memory, laid out [r][m][(k,l)] so the
//   row-parallel loops read it as a broadcast;
// - per-row vectors live in shared memory as [component][row] with a row
//   stride of tile + 1, so row-parallel loops are conflict-free and the
//   cell-parallel cross-stat loop reads distinct banks;
// - T, A1, A2, A3, D and scale are computed with one thread per
//   (row, component); the p cross-stats with one thread per (r, k, l, m)
//   cell looping over the tile's rows (no shared-memory atomics), held in
//   shared memory for the block's whole run and flushed once per block as
//   p * cross with atomicAdd;
// - theta_hat gets one atomicAdd per (row, position, k) with nonzero
//   weight; loglik is reduced per block, then one atomicAdd per block.
// Weight-0 rows are inert: their scale is 0 and they add nothing.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-30f;

__global__ void em_sweep_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    const int* __restrict__ rat,      // [B]
    const float* __restrict__ w,      // [B]
    float* __restrict__ theta_hat,    // [S, G, K], zeroed by the caller
    float* __restrict__ p_hat,        // [S, K, K, K, R], zeroed by the caller
    float* __restrict__ ll,           // [S], zeroed by the caller
    int B, int G, int K, int R, int tile, int rows_per_block) {
  const int s = blockIdx.y;
  const int K2 = K * K, K3 = K2 * K;
  const int RS = tile + 1;
  const int tid = threadIdx.x, nt = blockDim.x;

  extern __shared__ float smem[];
  float* p_sm = smem;                 // [R][K][K2]: p[s,k,l,m,r] at (r*K+m)*K2 + k*K+l
  float* cross = p_sm + R * K3;       // [R][K2][K]: cell (r*K2 + k*K+l)*K + m
  float* TV = cross + R * K3;         // [K2][RS]: T, then V = th1 th2 w/D
  float* th = TV + K2 * RS;           // [3][K][RS]: theta rows per position
  float* A = th + 3 * K * RS;         // [3][K][RS]: A1, A2, A3
  float* wv = A + 3 * K * RS;         // [RS]
  float* scale = wv + RS;             // [RS]
  int* gene = reinterpret_cast<int*>(scale + RS);  // [3][RS]
  int* rr = gene + 3 * RS;            // [RS]
  __shared__ float red[32];

  const float* p_s = p + (size_t)s * K3 * R;
  for (int i = tid; i < K3 * R; i += nt) {
    const int r = i % R, klm = i / R;
    const int m = klm % K, kl = klm / K;
    p_sm[(r * K + m) * K2 + kl] = p_s[i];
    cross[i] = 0.f;
  }

  const float* th_s = theta + (size_t)s * G * K;
  float* thh_s = theta_hat + (size_t)s * G * K;
  const float* th1 = th;
  const float* th2 = th + K * RS;
  const float* th3 = th + 2 * K * RS;
  float* A1 = A;
  float* A2 = A + K * RS;
  float* A3 = A + 2 * K * RS;
  float ll_acc = 0.f;

  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(B, row_begin + rows_per_block);
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += tile) {
    const int n = min(tile, row_end - row0);

    // Row metadata.  Rows past the end, and rows whose gene id or rating
    // is out of range (the callers check ids on the host and raise; this
    // only keeps memory safe), are inert: gene 0, rating 0, weight 0.
    for (int i = tid; i < tile; i += nt) {
      const int b = row0 + i;
      int g1 = 0, g2 = 0, g3 = 0, r = 0;
      bool valid = i < n;
      if (valid) {
        g1 = trip[3 * b];
        g2 = trip[3 * b + 1];
        g3 = trip[3 * b + 2];
        r = rat[b];
        valid = (unsigned)g1 < (unsigned)G && (unsigned)g2 < (unsigned)G &&
                (unsigned)g3 < (unsigned)G && (unsigned)r < (unsigned)R;
      }
      gene[i] = valid ? g1 : 0;
      gene[RS + i] = valid ? g2 : 0;
      gene[2 * RS + i] = valid ? g3 : 0;
      rr[i] = valid ? r : 0;
      wv[i] = valid ? w[b] : 0.f;
    }
    __syncthreads();

    // Gather theta rows of the three positions.
    for (int i = tid; i < 3 * K * tile; i += nt) {
      const int row = i % tile, j = i / tile;  // j = pos*K + k
      const int k = j % K, pos = j / K;
      th[j * RS + row] = th_s[(size_t)gene[pos * RS + row] * K + k];
    }
    __syncthreads();

    // T[k,l] = sum_m th3[m] p[k,l,m,r]
    for (int i = tid; i < K2 * tile; i += nt) {
      const int row = i % tile, kl = i / tile;
      const float* pr = p_sm + rr[row] * K * K2 + kl;
      float t = 0.f;
      for (int m = 0; m < K; ++m) t += th3[m * RS + row] * pr[m * K2];
      TV[kl * RS + row] = t;
    }
    __syncthreads();

    // A1[j] = sum_l th2[l] T[j,l];  A2[j] = sum_k th1[k] T[k,j];
    // A3[j] = sum_kl th1[k] th2[l] p[k,l,j,r]
    for (int i = tid; i < K * tile; i += nt) {
      const int row = i % tile, j = i / tile;
      const float* pr = p_sm + (rr[row] * K + j) * K2;
      float a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int k = 0; k < K; ++k) {
        const float t1 = th1[k * RS + row];
        a1 += th2[k * RS + row] * TV[(j * K + k) * RS + row];
        a2 += t1 * TV[(k * K + j) * RS + row];
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
    for (int i = tid; i < tile; i += nt) {
      float d = 0.f;
      for (int k = 0; k < K; ++k) d += th1[k * RS + i] * A1[k * RS + i];
      const float wi = wv[i];
      scale[i] = wi / (d + kEps);
      ll_acc += wi * logf(d + kEps);
    }
    __syncthreads();

    // theta_hat[gene_pos] += th_pos * A_pos * scale;  V = th1 th2 scale
    for (int i = tid; i < 3 * K * tile; i += nt) {
      const int row = i % tile, j = i / tile;
      if (wv[row] != 0.f) {
        const int k = j % K, pos = j / K;
        atomicAdd(&thh_s[(size_t)gene[pos * RS + row] * K + k],
                  th[j * RS + row] * A[j * RS + row] * scale[row]);
      }
    }
    for (int i = tid; i < K2 * tile; i += nt) {
      const int row = i % tile, kl = i / tile;
      TV[kl * RS + row] =
          th1[(kl / K) * RS + row] * th2[(kl % K) * RS + row] * scale[row];
    }
    __syncthreads();

    // cross[r][k,l][m] += sum over the tile's rows of rating r of V[k,l] th3[m]
    for (int c = tid; c < R * K3; c += nt) {
      const int m = c % K, rest = c / K;
      const int kl = rest % K2, r = rest / K2;
      float acc = 0.f;
      for (int row = 0; row < n; ++row)
        acc += rr[row] == r ? TV[kl * RS + row] * th3[m * RS + row] : 0.f;
      cross[c] += acc;
    }
    __syncthreads();
  }

  // Flush the block's p-stats as p * cross.
  float* ph_s = p_hat + (size_t)s * K3 * R;
  for (int c = tid; c < R * K3; c += nt) {
    const float v = cross[c];
    if (v != 0.f) {
      const int m = c % K, rest = c / K;
      const int kl = rest % K2, r = rest / K2;
      atomicAdd(&ph_s[(kl * K + m) * R + r], p_sm[(r * K + m) * K2 + kl] * v);
    }
  }

  // Block-reduce the log-likelihood, one atomic per block.
  for (int off = 16; off > 0; off >>= 1)
    ll_acc += __shfl_down_sync(0xffffffffu, ll_acc, off);
  if ((tid & 31) == 0) red[tid >> 5] = ll_acc;
  __syncthreads();
  if (tid < 32) {
    float v = tid < (nt + 31) / 32 ? red[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (tid == 0) atomicAdd(&ll[s], v);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller zeroes theta_hat, p_hat and ll and sizes smem_bytes from the
// host plan (ops/em_bdr.py sweep_plan).
extern "C" int tip_em_sweep(const void* theta, const void* p, const void* trip,
                            const void* rat, const void* w, void* theta_hat,
                            void* p_hat, void* ll, int S, int B, int G, int K,
                            int R, int tile, int rows_per_block, int threads,
                            int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        em_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + rows_per_block - 1) / rows_per_block, S);
  em_sweep_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)w, (float*)theta_hat, (float*)p_hat, (float*)ll, B, G, K,
      R, tile, rows_per_block);
  return (int)cudaGetLastError();
}
