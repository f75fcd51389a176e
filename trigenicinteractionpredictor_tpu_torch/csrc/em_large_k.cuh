// The large-K sweep algebra (21 <= K <= 72) shared by K3
// (csrc/em_sweep_large_k.cu) and K7 (csrc/em_hybrid.cu).  The two kernels
// differ only in where a row's theta values come from, which is the Rows
// template parameter of both passes:
//   GatherRows  -- theta[s, gene, :] read through the row's gene id (K3);
//   StreamRows  -- pre-gathered streams th_pos[b, s*K + k] (K7).
// Everything else -- the per-row algebra, the theta_hat scatter by gene id
// and the cross-stat pass -- is one code path.
//
// Rows in rating order.  The wrapper hands both passes `order`, a stable
// permutation of the batch by rating (int32 [B]: sorted position -> row),
// and `off` [R + 1], where rating r's rows are sorted positions off[r] ..
// off[r + 1] (rows with a rating out of range sort last and no block reads
// them).  Every block works on the rows of one rating, so it multiplies one
// rating's slice of p and no thread skips a row.  Rows are read through
// `order`; no row data is gathered into a new order on the host.
//
// Pass 1 (estep_kernel), grid (row tiles, S): a block owns one restart s and
// up to 64 rows of one rating r (a rating's rows are cut into tiles of 64
// alone, so at most R tiles are short).  Per k-slice of p[s] it computes
// two [rows, K] x [K, K] float32 products
//     T[b,l] = sum_m th3[b,m] p[k,l,m,r]    U[b,m] = sum_l th2[b,l] p[k,l,m,r]
// and folds them as they finish:
//     A2[b,l] += th1[b,k] T    A3[b,m] += th1[b,k] U    A1[b,k] = sum_l th2 T
//     D[b] += th1[b,k] A1[b,k]
// A thread owns a 4-row x 4-column register tile of T and U (columns are l
// for T, m for U), so A2 and A3 stay in registers across k; A1 is a sum over
// the threads that own a row's columns, through shared memory.
// - pack_kernel first lays p out once per call, per (s, r, k), as the two
//   products read it: PT[m][l] then PU[l][m], columns zero-padded to KC = K
//   rounded up to 4.  A stage is one product's operand (K x KC floats,
//   contiguous), copied with 16-byte cp.async, double-buffered: stage t + 1
//   is in flight while stage t is multiplied, one barrier a stage, no % or /
//   per element.
// - Per stage a thread reads one float4 of theta (4 rows at one j) and one
//   float4 of p (4 columns) per 16 multiply-adds.
// - Registers: 48 accumulators a thread, 96 registers (ptxas, no spill);
//   the block is 16 x KC/4 threads (288 at K = 72), two blocks per SM by
//   __launch_bounds__ and by shared memory (71,424 bytes at K = 50, 110,976
//   at K = 72; ops/em_large_k.py sweep_plan).
// It then scatters th_pos * A_pos * w/D into theta_hat (global atomics),
// adds w log D to loglik, writes scale = w/D in sorted order [S, B] and (the
// s = 0 blocks) each sorted row's (row, g1, g2, g3) for pass 2.
//
// Pass 2 (cross_kernel), grid (k chunks, S, R x splits): a block owns the
// cells cross[r][k, :, :] of NK consecutive k and one split of rating r's
// rows:
//     cross[r][k,l,m] = sum_b th1[b,k] scale_b th2[b,l] th3[b,m]
// a [K^2, rows] x [rows, K] product whose left operand is formed in
// registers.  A thread owns one k, 4 l and 8 m of one rating.  Rows come in
// stages of 64 by cp.async (their (row, genes) and scale two stages ahead,
// their theta rows one stage ahead, in 16-, 8- or 4-byte copies as K
// allows), double-buffered.  Every block gathers its rows' theta again, so
// the plan weighs the gathers against the compute when it picks NK (on the
// H100 at K = 50 a pass of 4-byte gathers alone took about as long as the
// compute alone).  The rows' sum is
// two-level: 64 rows apart, then into the run's total, as the earlier
// design did, so the error over 131,072 rows stays ~(64 + n/64) ulps.  A
// block flushes p * cross with one atomic per cell.  127 registers (130
// with StreamRows; ptxas, no spill), so one block of 364 (K = 50) or 324
// (K = 72) threads per SM; 85,760 bytes (K = 50) and 114,432 (K = 72) of
// shared memory.  Keeping the running totals in shared memory instead (97
// registers, two blocks per SM) ran slower on the H100.
//
// What bounds it on the H100: ~3 K^3 multiply-adds per row and restart
// (2 K^3 in pass 1, K^3 in pass 2), float32 outside the tensor cores (67
// TFLOP/s).  The register tiles make the loops bound by the FMA rate rather
// than by shared-memory bandwidth (the earlier design read one p value of
// its own per multiply-add in pass 1): pass 1 runs at ~45% of the float32
// peak at K = 72, pass 2 at ~20% (its rows' theta gathered again per k
// chunk, one block per SM).  Exact float32: no tensor cores, no TF32.
//
// Weight-0 rows, and rows with an out-of-range gene id (the callers check
// ids on the host and raise; this only keeps memory safe), have scale 0 and
// add nothing to any output; rows with an out-of-range rating are never
// read.  Rows past B read nothing.

#pragma once

#include <cuda_runtime.h>

namespace large_k {
namespace {  // internal linkage: each kernel source instantiates its own

constexpr float kEps = 1e-30f;
constexpr int kRows1 = 64;              // pass 1: rows per block
constexpr int kTS = kRows1 + 4;         // pass 1: row stride of theta tiles
constexpr int kMaxThreads1 = 288;       // pass 1 at K = 72: 16 x 18
constexpr int kRows2 = 64;              // pass 2: rows per stage
constexpr int kSumRows2 = 64;           // pass 2: rows per partial sum
constexpr int kMaxThreads2 = 384;       // pass 2 (ops/em_large_k.py)

// A row source hands each pass one restart's view (at), hoisting the
// restart's offset out of the loops; the view returns the address of the
// theta value of row b (gene id `gene`) at position pos and index k.
//
// theta[s, gene, k] through the row's gene id (G genes per restart).
struct GatherRows {
  const float* theta;  // [S, G, K]
  int G;
  struct Restart {
    const float* th;   // theta[s]
    int K;
    __device__ __forceinline__ const float* operator()(int pos, int b, int gene,
                                                       int k) const {
      return th + (size_t)gene * K + k;
    }
  };
  __device__ __forceinline__ Restart at(int s, int K) const {
    return Restart{theta + (size_t)s * G * K, K};
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
    __device__ __forceinline__ const float* operator()(int pos, int b, int gene,
                                                       int k) const {
      const float* t = pos == 0 ? t1 : (pos == 1 ? t2 : t3);
      return t + (size_t)b * SK + k;
    }
  };
  __device__ __forceinline__ Restart at(int s, int K) const {
    return Restart{th1 + s * K, th2 + s * K, th3 + s * K, S * K};
  }
};

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async8(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Tile x of the rating-ordered rows cut into tiles of `rows` per rating:
// false past the last tile, else its rating r and sorted rows [a, a + n).
__device__ __forceinline__ bool rating_tile(const int* __restrict__ off, int R,
                                            int rows, int x, int& r, int& a,
                                            int& n) {
  for (r = 0; r < R; ++r) {
    const int lo = off[r], hi = off[r + 1];
    const int tiles = (hi - lo + rows - 1) / rows;
    if (x < tiles) {
      a = lo + x * rows;
      n = min(rows, hi - a);
      return true;
    }
    x -= tiles;
  }
  return false;
}

// p[s, k, :, :, r] as the two products of pass 1 read it, per (s, r, k):
//   pk[((s R + r) K + k) 2 K KC + j KC + c]          = p[s,k,c,j,r]  (PT[m=j][l=c])
//   pk[((s R + r) K + k) 2 K KC + (K + j) KC + c]    = p[s,k,j,c,r]  (PU[l=j][m=c])
// 0 for c >= K.  Grid (K, R, S).
__global__ void pack_kernel(const float* __restrict__ p, float* __restrict__ pk,
                            int K, int R, int KC) {
  const int k = blockIdx.x, r = blockIdx.y, s = blockIdx.z;
  const float* src = p + ((size_t)s * K + k) * K * K * R;
  float* dst = pk + (((size_t)s * R + r) * K + k) * 2 * K * KC;
  for (int i = threadIdx.x; i < K * KC; i += blockDim.x) {
    const int j = i / KC, c = i - j * KC;
    const bool in = c < K;
    dst[i] = in ? src[((size_t)c * K + j) * R + r] : 0.f;
    dst[K * KC + i] = in ? src[((size_t)j * K + c) * R + r] : 0.f;
  }
}

// Pass 1.  blockDim.x = 16 NCG, NCG = KC / 4: thread t owns rows 4 (t / NCG)
// .. + 3 and columns 4 (t % NCG) .. + 3.
// Shared memory (floats):
//   stage [2][K][KC]        two stages of pk (one product's operand each)
//   th    [3][KC][kTS]      theta of the tile's rows per position, [k][row];
//                           0 past K and past n; th1[k] becomes th1 A1 once
//                           A1[k] is summed
//   red   [2][NCG][kRows1]  partial sums of A1 over column groups, two k's
//   wv, sc [kRows1]; as ints gene [3][kRows1], row [kRows1]
template <typename Rows>
__global__ void __launch_bounds__(kMaxThreads1, 2) estep_kernel(
    Rows rows,                        // theta values of a row, see above
    const float* __restrict__ pk,     // [S, R, K, 2, K, KC] from pack_kernel
    const int* __restrict__ trip,     // [B, 3]
    const float* __restrict__ w,      // [B]
    const int* __restrict__ order,    // [B] sorted position -> row
    const int* __restrict__ off,      // [R + 1] rating segments of order
    float* __restrict__ theta_hat,    // [S, G, K], zeroed by the caller
    float* __restrict__ ll,           // [S], zeroed by the caller
    float* __restrict__ scale_out,    // [S, B] in sorted order
    int4* __restrict__ rowinfo,       // [B] (row, g1, g2, g3) in sorted order
    int B, int G, int K, int R, int KC) {
  const int s = blockIdx.y;
  int r, a, n;
  if (!rating_tile(off, R, kRows1, blockIdx.x, r, a, n)) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NCG = KC >> 2;
  const int cg = tid % NCG, rg = tid / NCG;
  const int stage_floats = K * KC;

  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* th = stage + 2 * stage_floats;
  float* red = th + 3 * KC * kTS;
  float* wv = red + 2 * NCG * kRows1;
  float* sc = wv + kRows1;
  int* gene = reinterpret_cast<int*>(sc + kRows1);
  int* brow = gene + 3 * kRows1;

  const float* pk_sr = pk + ((size_t)s * R + r) * 2 * K * stage_floats;
  auto load_stage = [&](int t) {
    float* dst = stage + (t & 1) * stage_floats;
    const float* src = pk_sr + (size_t)t * stage_floats;
    for (int i = 4 * tid; i < stage_floats; i += 4 * nt) copy_async16(dst + i, src + i);
  };
  load_stage(0);
  commit();

  // Row metadata.  Rows with a gene id out of range are inert: genes 0,
  // weight 0.
  for (int i = tid; i < kRows1; i += nt) {
    int b = 0, g1 = 0, g2 = 0, g3 = 0;
    float wi = 0.f;
    if (i < n) {
      b = order[a + i];
      g1 = trip[3 * b];
      g2 = trip[3 * b + 1];
      g3 = trip[3 * b + 2];
      if ((unsigned)g1 < (unsigned)G && (unsigned)g2 < (unsigned)G &&
          (unsigned)g3 < (unsigned)G) {
        wi = w[b];
      } else {
        g1 = g2 = g3 = 0;
      }
      if (s == 0) rowinfo[a + i] = make_int4(b, g1, g2, g3);
    }
    gene[i] = g1;
    gene[kRows1 + i] = g2;
    gene[2 * kRows1 + i] = g3;
    brow[i] = b;
    wv[i] = wi;
  }
  __syncthreads();
  const auto rows_s = rows.at(s, K);
  for (int i = tid; i < 3 * KC * kRows1; i += nt) {
    const int k = i % KC, pr = i / KC;  // pr = pos * kRows1 + row
    const int row = pr % kRows1, pos = pr / kRows1;
    th[(pos * KC + k) * kTS + row] =
        (k < K && row < n) ? *rows_s(pos, brow[row], gene[pr], k) : 0.f;
  }

  const float* th1 = th;
  const float* th2 = th + KC * kTS;
  const float* th3 = th + 2 * KC * kTS;
  float acc[4][4], a2[4][4], a3[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) a2[i][c] = a3[i][c] = 0.f;
  float d = 0.f;  // D of row tid (tid < kRows1)

  // A1[tid, k] from the column groups' partial sums; D += th1 A1; th1[k]
  // becomes th1 A1, position 1's marginal before the scale.
  auto finish_a1 = [&](int k) {
    if (tid < kRows1) {
      const float* rk = red + (k & 1) * NCG * kRows1 + tid;
      float q = 0.f;
      for (int g = 0; g < NCG; ++g) q += rk[g * kRows1];
      float* t1 = th + k * kTS + tid;
      d += *t1 * q;
      *t1 *= q;
    }
  };

  const int n_stages = 2 * K;
  for (int t = 0; t < n_stages; ++t) {
    wait_all();
    __syncthreads();  // stage t has landed; stage t - 1 is consumed
    if (t + 1 < n_stages) load_stage(t + 1);
    commit();
    const int k = t >> 1;
    if ((t & 1) == 0 && k > 0) finish_a1(k - 1);

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    const float* ap = ((t & 1) ? th2 : th3) + 4 * rg;
    const float* bp = stage + (t & 1) * stage_floats + 4 * cg;
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(ap + j * kTS);
      const float4 y = *reinterpret_cast<const float4*>(bp + j * KC);
      const float xv[4] = {x.x, x.y, x.z, x.w};
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += xv[i] * yv[c];
    }

    const float4 t1 = *reinterpret_cast<const float4*>(th1 + k * kTS + 4 * rg);
    const float t1v[4] = {t1.x, t1.y, t1.z, t1.w};
    if ((t & 1) == 0) {  // T: A2 += th1 T; A1's partial sum over my columns
      float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 g = *reinterpret_cast<const float4*>(th2 + (4 * cg + c) * kTS + 4 * rg);
        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a2[i][c] += t1v[i] * acc[i][c];
          q[i] += gv[i] * acc[i][c];
        }
      }
      *reinterpret_cast<float4*>(red + ((k & 1) * NCG + cg) * kRows1 + 4 * rg) =
          make_float4(q[0], q[1], q[2], q[3]);
    } else {  // U: A3 += th1 U
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) a3[i][c] += t1v[i] * acc[i][c];
    }
  }
  __syncthreads();
  finish_a1(K - 1);

  float* thh_s = theta_hat + (size_t)s * G * K;
  float ll_acc = 0.f;
  if (tid < kRows1) {
    const float wr = wv[tid];
    sc[tid] = wr / (d + kEps);
    ll_acc = wr * logf(d + kEps);
    if (tid < n) scale_out[(size_t)s * B + a + tid] = sc[tid];
  }
  __syncthreads();

  // Positions 2 and 3 from the register tiles, position 1 from th1 A1.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * rg + i;
    if (row < n && wv[row] != 0.f) {
      const float sr = sc[row];
      float* h2 = thh_s + (size_t)gene[kRows1 + row] * K;
      float* h3 = thh_s + (size_t)gene[2 * kRows1 + row] * K;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * cg + c;
        if (col < K) {
          atomicAdd(h2 + col, th2[col * kTS + row] * a2[i][c] * sr);
          atomicAdd(h3 + col, th3[col * kTS + row] * a3[i][c] * sr);
        }
      }
    }
  }
  for (int i = tid; i < n * K; i += nt) {
    const int row = i / K, k = i - row * K;
    if (wv[row] != 0.f)
      atomicAdd(thh_s + (size_t)gene[row] * K + k, th1[k * kTS + row] * sc[row]);
  }
  if (tid < kRows1) {
    for (int o = 16; o > 0; o >>= 1) ll_acc += __shfl_down_sync(0xffffffffu, ll_acc, o);
    if ((tid & 31) == 0) atomicAdd(&ll[s], ll_acc);
  }
}

// Pass 2.  blockDim.x = NK LQ MQ with LQ = ceil(K / 4), MQ = ceil(K / 8):
// thread t owns k = NK blockIdx.x + t / (LQ MQ), l = 4 lq .. + 3 and
// m = 8 mq .. + 7 (lq = (t / MQ) % LQ, mq = t % MQ) of rating r.
// Shared memory (floats; LP = 4 LQ, MP = 8 MQ):
//   th1, th2 [2][kRows2][LP]; th3 [2][kRows2][MP] (zeroed once: pads stay 0)
//   info [3][kRows2] int4 (row, g1, g2, g3); sc [3][kRows2]
template <typename Rows>
__global__ void __launch_bounds__(kMaxThreads2, 1) cross_kernel(
    Rows rows,                        // theta values of a row, see above
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int4* __restrict__ rowinfo, // [B] from pass 1
    const float* __restrict__ scale,  // [S, B] from pass 1, sorted order
    const int* __restrict__ off,      // [R + 1]
    float* __restrict__ p_hat,        // [S, K, K, K, R], zeroed by the caller
    int B, int K, int R, int NK, int splits, int vec) {
  const int s = blockIdx.y;
  const int r = blockIdx.z / splits, split = blockIdx.z - r * splits;
  const int lo = off[r], hi = off[r + 1];
  const int per = (hi - lo + splits - 1) / splits;
  const int a = lo + split * per, e = min(hi, a + per);
  if (a >= e) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;  // whole warps
  const int LQ = (K + 3) >> 2, MQ = (K + 7) >> 3, LP = 4 * LQ, MP = 8 * MQ;
  const int mq = tid % MQ, lq = (tid / MQ) % LQ;
  const int k = NK * blockIdx.x + tid / (MQ * LQ);
  const int kr = min(k, K - 1);

  extern __shared__ float4 smem4[];
  float* t1s = reinterpret_cast<float*>(smem4);
  float* t2s = t1s + 2 * kRows2 * LP;
  float* t3s = t2s + 2 * kRows2 * LP;
  int4* info = reinterpret_cast<int4*>(t3s + 2 * kRows2 * MP);
  float* scs = reinterpret_cast<float*>(info + 3 * kRows2);
  for (int i = tid; i < 2 * kRows2 * (2 * LP + MP); i += nt) t1s[i] = 0.f;
  __syncthreads();  // the zero fill lands before any copy into the buffers

  const auto rows_s = rows.at(s, K);
  const float* sc_s = scale + (size_t)s * B;
  const int n_stages = (e - a + kRows2 - 1) / kRows2;
  auto load_info = [&](int t) {
    const int p0 = a + t * kRows2, n_t = min(kRows2, e - p0);
    const int buf = t % 3;
    for (int i = tid; i < n_t; i += nt) {
      copy_async16(info + buf * kRows2 + i, rowinfo + p0 + i);
      copy_async4(scs + buf * kRows2 + i, sc_s + p0 + i);
    }
  };
  // Theta rows of stage t (its info has landed): a whole warp per (row,
  // position), lanes along k in copies of vec floats (16, 8 or 4 bytes: the
  // widest that K and so every row's start allow); a last, partial warp
  // copies nothing.
  const int n_vec = K / vec;
  auto load_theta = [&](int t) {
    const int n_t = min(kRows2, e - a - t * kRows2);
    const int4* in = info + (t % 3) * kRows2;
    const int buf = t & 1;
    for (int rp = warp; rp < 3 * n_t; rp += n_warps) {
      const int row = rp / 3, pos = rp - 3 * row;
      const int4 ri = in[row];
      const int g = pos == 0 ? ri.y : (pos == 1 ? ri.z : ri.w);
      float* dst = pos == 2 ? t3s + (buf * kRows2 + row) * MP
                            : (pos == 0 ? t1s : t2s) + (buf * kRows2 + row) * LP;
      for (int v = lane; v < n_vec; v += 32) {
        const float* src = rows_s(pos, ri.x, g, v * vec);
        if (vec == 4)
          copy_async16(dst + 4 * v, src);
        else if (vec == 2)
          copy_async8(dst + 2 * v, src);
        else
          copy_async4(dst + v, src);
      }
    }
  };

  load_info(0);
  if (n_stages > 1) load_info(1);
  commit();
  wait_all();
  __syncthreads();
  load_theta(0);
  commit();

  float acc[4][8], part[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int t = 0; t < n_stages; ++t) {
    wait_all();
    __syncthreads();  // stage t's rows and stage t + 1's info have landed
    if (t + 1 < n_stages) load_theta(t + 1);
    if (t + 2 < n_stages) load_info(t + 2);
    commit();

    const int n_t = min(kRows2, e - a - t * kRows2);
    const int buf = t & 1;
    const float* p1 = t1s + buf * kRows2 * LP + kr;
    const float* p2 = t2s + buf * kRows2 * LP + 4 * lq;
    const float* p3 = t3s + buf * kRows2 * MP + 8 * mq;
    const float* ps = scs + (t % 3) * kRows2;
#pragma unroll 4
    for (int row = 0; row < n_t; ++row) {
      const float c1 = p1[row * LP] * ps[row];
      const float4 x = *reinterpret_cast<const float4*>(p2 + row * LP);
      const float4 y0 = *reinterpret_cast<const float4*>(p3 + row * MP);
      const float4 y1 = *reinterpret_cast<const float4*>(p3 + row * MP + 4);
      const float xv[4] = {c1 * x.x, c1 * x.y, c1 * x.z, c1 * x.w};
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] += xv[i] * yv[j];
    }
    if ((t + 1) * kRows2 % kSumRows2 == 0 || t + 1 == n_stages) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }

  if (k < K) {
    const size_t base = ((size_t)s * K + k) * K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = 4 * lq + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = 8 * mq + j;
        const float v = acc[i][j];
        if (l < K && m < K && v != 0.f) {
          const size_t idx = ((base + l) * K + m) * R + r;
          atomicAdd(&p_hat[idx], p[idx] * v);
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

// Launch the pack and both passes on `stream`; returns cudaGetLastError()
// (0 on success).  The caller zeroes theta_hat, p_hat and ll, allocates pk
// [S, R, K, 2, K, KC], scale [S, B] and rowinfo [B, 4], computes the rating
// order and its segments, and sizes the blocks and shared memory from the
// host plan (ops/em_large_k.py sweep_plan).
template <typename Rows>
int launch(Rows rows, const void* p, const void* trip, const void* w,
           const void* order, const void* off, void* pk, void* theta_hat,
           void* p_hat, void* ll, void* scale, void* rowinfo, int S, int B,
           int G, int K, int R, int KC, int estep_threads, int estep_smem,
           int nk, int splits, int vec, int cross_threads, int cross_smem,
           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  pack_kernel<<<dim3(K, R, S), 256, 0, st>>>((const float*)p, (float*)pk, K, R, KC);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(estep_kernel<Rows>, estep_smem))) return err;
  const int tiles = (B + kRows1 - 1) / kRows1 + R;
  estep_kernel<Rows><<<dim3(tiles, S), estep_threads, estep_smem, st>>>(
      rows, (const float*)pk, (const int*)trip, (const float*)w, (const int*)order,
      (const int*)off, (float*)theta_hat, (float*)ll, (float*)scale,
      (int4*)rowinfo, B, G, K, R, KC);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(cross_kernel<Rows>, cross_smem))) return err;
  cross_kernel<Rows><<<dim3((K + nk - 1) / nk, S, R * splits), cross_threads,
                       cross_smem, st>>>(
      rows, (const float*)p, (const int4*)rowinfo, (const float*)scale,
      (const int*)off, (float*)p_hat, B, K, R, nk, splits, vec);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace large_k
