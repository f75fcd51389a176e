// K2: the ensemble serving scorer, hand-written for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_score.py,
//   _score_tile_kernel (launched by _pallas_score), together with the
//   restart mean its caller pallas_ensemble_predict_interaction takes.
//   Computes, for every row b,
//       out[b] = (1/S) sum_s sum_klm th1[k] th2[l] th3[m] p_s[k,l,m,ir]
//   i.e. the sample-averaged P(r = ir | genes) of ops/scoring.py.  Only
//   the interaction rating's slice of p is read.
//
// Supported shapes: any K whose plan fits shared memory (the host plan in
// ops/score.py; K <= 136); any S, any R, and no cap on G: theta rows are
// read from global memory, where the TPU kernel held [rows, G] one-hots in
// VMEM and fell back to a jnp scorer past its G cap.
//
// What bounds it on the H100: operations.  K^3 multiply-adds per row and
// restart against the K^3 slice p[s,...,ir]; theta (G*S*K floats) and the
// slice sit in L2 at the serving shapes.  So the design is a float32 matrix
// product with register tiles, where a shared-memory read feeds many
// multiply-adds (exact float32: no tensor cores, no TF32).
//
// Design.  One restart's work for a tile of rows is
//     C[b, (k,l)] = sum_m th3[b,m] P[m, (k,l)]          (the product)
//     out[b]     += sum_(k,l) th1[b,k] th2[b,l] C[b, (k,l)]  (the epilogue)
// with C never written out.  (k,l) runs flat over K^2, so no padding of K
// is multiplied: the product's width is K^2 rounded up to the block's
// chunk, and its depth is exactly K.
// - pack_kernel first writes the interaction rating's slice of every p[s]
//   as P[s][m][(k,l)], contiguous in (k,l) and zero-padded to a whole
//   number of chunks (a tiled transpose), so a stage is 16-byte copies.
// - score_kernel: a warp owns 64 rows x 32 (k,l); a thread an 8 x 8
//   register tile of C (rows 4 + 4, (k,l) 4 + 4, so that the four float4
//   reads of a step are conflict-free and mostly broadcasts: 4 shared-
//   memory wavefronts per 64 multiply-adds of a warp).  A block is `wkl`
//   warps along (k,l) by `wr` warps along rows (the host plan picks wkl
//   from K so that little of the last chunk is padding: 8 x 1 at K = 50,
//   4 x 2 at K = 10).
// - The block walks restarts, (k,l) chunks and m in stages of 16 m's of P
//   (16 x chunk floats), double-buffered with cp.async: the next stage's
//   copies are in flight while this one is multiplied; one barrier a stage.
//   The rows' theta of the next restart (three [K][rows] tiles, gathered by
//   gene id with 4-byte cp.async) is double-buffered the same way.
// - After the last m of a chunk the epilogue folds C into the rows' sums
//   with th2 then th1; at the end the partial sums of the threads that
//   share a row are added in a fixed order and the restart mean is written.

#include <cuda_runtime.h>

namespace {

constexpr int kStageM = 16;     // m's of P per stage (STAGE_M in ops/score.py)
constexpr int kWarpRows = 64;   // rows per warp
constexpr int kWarpKl = 32;     // (k,l) per warp
constexpr int kMaxThreads = 256;

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// P[s][m][kl] = p[s, k, l, m, ir] (kl = k K + l), 0 for K^2 <= kl < KLP.
// Grid (KLP / 32, ceil(K / 32), S), block (32, 8): a 32 x 32 tile through
// shared memory, read along m and written along kl.
__global__ void pack_kernel(const float* __restrict__ p, float* __restrict__ pt,
                            int K, int R, int ir, int KLP) {
  __shared__ float tile[32][33];
  const int K2 = K * K;
  const int kl0 = blockIdx.x * 32, m0 = blockIdx.y * 32, s = blockIdx.z;
  const float* p_s = p + (size_t)s * K2 * K * R;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int kl = kl0 + i, m = m0 + threadIdx.x;
    tile[i][threadIdx.x] = (kl < K2 && m < K) ? p_s[((size_t)kl * K + m) * R + ir] : 0.f;
  }
  __syncthreads();
  float* pt_s = pt + (size_t)s * K * KLP;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int m = m0 + i, kl = kl0 + threadIdx.x;
    if (m < K) pt_s[(size_t)m * KLP + kl] = tile[threadIdx.x][i];
  }
}

// Shared memory (floats; ROWS = 64 wr, KLC = 32 wkl):
//   th   [2][3][K][ROWS]   the rows' theta per position, two restarts
//   ps   [2][kStageM][KLC] two stages of P; reused as red [wkl][ROWS]
//   gene [3][ROWS] ints
__global__ void __launch_bounds__(kMaxThreads, 2) score_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ pt,     // [S, K, KLP] from pack_kernel
    const int* __restrict__ trip,     // [B, 3]
    float* __restrict__ out,          // [B]
    int S, int B, int G, int K, int KLP, int wkl, int wr) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int w_kl = warp % wkl, w_r = warp / wkl;
  const int ROWS = wr * kWarpRows, KLC = wkl * kWarpKl;
  const int K2 = K * K;
  const int row0 = blockIdx.x * ROWS;
  const int my_row = w_r * kWarpRows + (lane >> 2) * 4;  // and + 32
  const int my_kl = w_kl * kWarpKl + (lane & 3) * 4;     // and + 16

  extern __shared__ float4 smem4[];
  float* th = reinterpret_cast<float*>(smem4);
  float* ps = th + 2 * 3 * K * ROWS;
  int* gene = reinterpret_cast<int*>(ps + 2 * kStageM * KLC);
  __shared__ int bad_row;

  // A row with a gene id out of range scores NaN (callers check ids on
  // the host and raise; this only keeps memory safe).  Rows past B read
  // gene 0 and are not written.
  if (tid == 0) bad_row = 0;
  __syncthreads();
  for (int i = tid; i < 3 * ROWS; i += nt) {
    const int pos = i / ROWS, row = i - pos * ROWS;
    int g = 0;
    if (row0 + row < B) {
      g = trip[3 * (row0 + row) + pos];
      if ((unsigned)g >= (unsigned)G) {
        g = 0;
        bad_row = 1;
      }
    }
    gene[i] = g;
  }
  __syncthreads();

  const int n_chunks = KLP / KLC;
  const int n_mst = (K + kStageM - 1) / kStageM;
  const int n_stages = S * n_chunks * n_mst;

  // The copies of restart s's theta tiles and of stage (s, c, ms) of P.
  // Element i of a restart's theta tiles: lane part i & 7 = tid & 7 (the
  // block has whole warps), the rest counts k fastest, then 8-row octets,
  // then positions.  A thread's elements are nt apart, so (k, octet) step
  // by constants: no division in the loop.
  const int oct_log2 = 31 - __clz(ROWS / 8);  // ROWS / 8 = 8 wr, a power of two
  const int k_first = (tid >> 3) % K, po_first = (tid >> 3) / K;
  const int k_step = (nt >> 3) % K, po_step = (nt >> 3) / K;
  auto load_theta = [&](int s) {
    // Consecutive threads take 8 rows, then the next k: a warp reads 16
    // contiguous bytes of 8 theta rows and writes 8 rows of 4 k's.
    float* dst = th + (s & 1) * 3 * K * ROWS;
    const float* th_s = theta + (size_t)s * G * K;
    int k = k_first, po = po_first;  // po = pos * (ROWS / 8) + octet
    for (int i = tid; i < 3 * ROWS * K; i += nt) {
      const int pos = po >> oct_log2;
      const int pr = pos * ROWS + ((po - (pos << oct_log2)) << 3) + (tid & 7);
      copy_async4(dst + (pos * K + k) * ROWS + (pr - pos * ROWS),
                  th_s + (size_t)gene[pr] * K + k);
      k += k_step;
      po += po_step;
      if (k >= K) {
        k -= K;
        ++po;
      }
    }
  };
  auto load_stage = [&](int t, int s, int c, int ms) {
    float* dst = ps + (t & 1) * kStageM * KLC;
    const int m0 = ms * kStageM, mn = min(kStageM, K - m0);
    const float* src = pt + ((size_t)s * K + m0) * KLP + c * KLC;
    const int q4 = KLC / 4;
    for (int i = tid; i < mn * q4; i += nt) {
      const int mm = i / q4, q = i - mm * q4;
      copy_async16(dst + mm * KLC + 4 * q, src + (size_t)mm * KLP + 4 * q);
    }
  };

  load_theta(0);
  load_stage(0, 0, 0, 0);
  asm volatile("cp.async.commit_group;" ::: "memory");

  float acc[8];  // the rows' sums over restarts and (k,l)
  float C[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  int s = 0, c = 0, ms = 0;     // the stage being multiplied
  int ns = 0, nc = 0, nms = 0;  // the stage being copied
  for (int t = 0; t < n_stages; ++t) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // stage t has landed; everyone is done with stage t - 1
    if (++nms == n_mst) {
      nms = 0;
      if (++nc == n_chunks) {
        nc = 0;
        ++ns;
      }
    }
    if (t + 1 < n_stages) {
      if (nms == 0 && nc == 0) load_theta(ns);
      load_stage(t + 1, ns, nc, nms);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");

    if (ms == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) C[i][j] = 0.f;
    }
    const float* th_s = th + (s & 1) * 3 * K * ROWS;
    const int m0 = ms * kStageM, mn = min(kStageM, K - m0);
    const float* a_ptr = th_s + (2 * K + m0) * ROWS + my_row;
    const float* b_ptr = ps + (t & 1) * kStageM * KLC + my_kl;
#pragma unroll 4
    for (int mm = 0; mm < mn; ++mm) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_ptr + mm * ROWS);
      const float4 a1 = *reinterpret_cast<const float4*>(a_ptr + mm * ROWS + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(b_ptr + mm * KLC);
      const float4 b1 = *reinterpret_cast<const float4*>(b_ptr + mm * KLC + 16);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) C[i][j] += a[i] * b[j];
    }

    if (ms == n_mst - 1) {
      // Epilogue: acc[i] += sum_j th1[k_j] th2[l_j] C[i][j], summing the
      // (k,l) of one k with th2 first, then once with th1.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kl0 = c * KLC + my_kl + 16 * h;
        int k = kl0 / K, l = kl0 - k * K;
        float u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) u[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (kl0 + jj < K2) {
            const float* t2 = th_s + (K + l) * ROWS + my_row;
            const float4 x0 = *reinterpret_cast<const float4*>(t2);
            const float4 x1 = *reinterpret_cast<const float4*>(t2 + 32);
            const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) u[i] += x[i] * C[i][4 * h + jj];
            const bool last = jj == 3 || l == K - 1 || kl0 + jj + 1 >= K2;
            if (last) {
              const float* t1 = th_s + k * ROWS + my_row;
              const float4 y0 = *reinterpret_cast<const float4*>(t1);
              const float4 y1 = *reinterpret_cast<const float4*>(t1 + 32);
              const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                acc[i] += y[i] * u[i];
                u[i] = 0.f;
              }
            }
            if (++l == K) {
              l = 0;
              ++k;
            }
          }
        }
      }
    }

    if (++ms == n_mst) {
      ms = 0;
      if (++c == n_chunks) {
        c = 0;
        ++s;
      }
    }
  }

  // Add the sums of the threads that share a row: the four lanes of a
  // quad, then the wkl warps along (k,l) through shared memory, in order.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
  }
  __syncthreads();  // the last stage is consumed: ps becomes red
  float* red = ps;
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      red[w_kl * ROWS + my_row + (i & 3) + 32 * (i >> 2)] = acc[i];
  }
  __syncthreads();
  const bool nan_rows = bad_row != 0;
  for (int row = tid; row < ROWS; row += nt) {
    const int b = row0 + row;
    if (b >= B) continue;
    float v = 0.f;
    for (int wq = 0; wq < wkl; ++wq) v += red[wq * ROWS + row];
    bool in_range = true;
    if (nan_rows) {
      for (int pos = 0; pos < 3; ++pos)
        in_range = in_range && (unsigned)trip[3 * b + pos] < (unsigned)G;
    }
    out[b] = in_range ? v / (float)S : __int_as_float(0x7fc00000);
  }
}

}  // namespace

// Launch the pack and the scorer on `stream`; returns cudaGetLastError()
// (0 on success).  pt holds S * K * KLP floats, KLP = K^2 rounded up to a
// multiple of 32 wkl; the block is wkl x wr warps (at most 8) and
// smem_bytes its dynamic shared memory, from the host plan (ops/score.py
// score_plan).
extern "C" int tip_score(const void* theta, const void* p, const void* trip,
                         void* pt, void* out, int S, int B, int G, int K, int R,
                         int ir, int KLP, int wkl, int wr, int smem_bytes,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  pack_kernel<<<dim3(KLP / 32, (K + 31) / 32, S), dim3(32, 8), 0, st>>>(
      (const float*)p, (float*)pt, K, R, ir, KLP);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = wr * kWarpRows;
  score_kernel<<<(B + rows - 1) / rows, wkl * wr * 32, smem_bytes, st>>>(
      (const float*)theta, (const float*)pt, (const int*)trip, (float*)out, S, B,
      G, K, KLP, wkl, wr);
  return (int)cudaGetLastError();
}
