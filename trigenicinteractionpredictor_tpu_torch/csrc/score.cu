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
// ops/score.py; K <= 115 at 128 threads); any S, any R, and no cap on G:
// theta rows are read from global memory, where the TPU kernel held
// [rows, G] one-hots in VMEM and fell back to a jnp scorer past its G cap.
//
// What bounds it on the H100: K^3 multiply-adds per row and restart
// against the K^3 slice p[s,...,ir]; theta (G*S*K floats) sits in L2 at
// the serving shapes, so shared-memory traffic of the K^3 loop bounds it,
// not HBM or the float32 rate.
//
// Design: one thread per row, `blockDim.x` rows per block.  For each
// restart the block stages p[s,...,ir] in shared memory in chunks of
// `k_chunk` k-slices, each row of m zero-padded to KP = K rounded up to 4
// (all of p[s] in one chunk while it fits half the shared memory, so two
// blocks share an SM), and each thread stages its own theta rows as
// [component][row] (conflict-free).  The K^3 contraction nests as
// sum_k th1 (sum_l th2 (sum_m th3 p)) with m taken 4 at a time: the four
// th3 values sit in registers while the thread walks all (k, l) of the
// chunk, reading p as float4 broadcasts (every thread of a warp reads the
// same element), so a warp issues ~0.5 shared-memory wavefronts per
// multiply-add.  The restart mean accumulates in a register.

#include <cuda_runtime.h>

namespace {

__global__ void score_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    float* __restrict__ out,          // [B]
    int S, int B, int G, int K, int R, int ir, int k_chunk) {
  const int K2 = K * K, K3 = K2 * K;
  const int tile = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.x * tile + tid;
  const bool valid = b < B;

  const int KP = (K + 3) & ~3;
  extern __shared__ float4 smem4[];
  float* p_sm = reinterpret_cast<float*>(smem4);  // [k_chunk][K][KP]: p[s,k,l,m,ir]
  float* th = p_sm + k_chunk * K * KP;            // [3][K][tile]

  // A row with a gene id out of range scores NaN (callers check ids on
  // the host and raise; this only keeps memory safe).
  int g[3] = {0, 0, 0};
  bool in_range = true;
  for (int pos = 0; valid && pos < 3; ++pos) {
    g[pos] = trip[3 * b + pos];
    in_range = in_range && (unsigned)g[pos] < (unsigned)G;
  }
  if (!in_range) g[0] = g[1] = g[2] = 0;
  const float* t1 = th + tid;
  const float* t2 = th + K * tile + tid;
  const float* t3 = th + 2 * K * tile + tid;

  float acc = 0.f;
  for (int s = 0; s < S; ++s) {
    // Each thread reads only its own theta rows: no barrier needed here.
    const float* th_s = theta + (size_t)s * G * K;
    for (int pos = 0; pos < 3; ++pos)
      for (int k = 0; k < K; ++k)
        th[(pos * K + k) * tile + tid] = th_s[(size_t)g[pos] * K + k];
    const float* p_s = p + (size_t)s * K3 * R;
    float d = 0.f;
    for (int k0 = 0; k0 < K; k0 += k_chunk) {
      const int kn = min(k_chunk, K - k0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = tid; i < kn * K * KP; i += tile) {
        const int m = i % KP, kl = i / KP;
        p_sm[i] = m < K ? p_s[(((size_t)k0 * K2) + kl * K + m) * R + ir] : 0.f;
      }
      __syncthreads();
      for (int m0 = 0; m0 < KP; m0 += 4) {
        float h[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) h[c] = m0 + c < K ? t3[(m0 + c) * tile] : 0.f;
        for (int kk = 0; kk < kn; ++kk) {
          const float* pr = p_sm + kk * K * KP + m0;
          float dk = 0.f;
          for (int l = 0; l < K; ++l) {
            const float4 q = *reinterpret_cast<const float4*>(pr + l * KP);
            dk += t2[l * tile] * (h[0] * q.x + h[1] * q.y + h[2] * q.z + h[3] * q.w);
          }
          d += t1[(k0 + kk) * tile] * dk;
        }
      }
    }
    acc += d;
  }
  if (valid) out[b] = in_range ? acc / (float)S : __int_as_float(0x7fc00000);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tip_score(const void* theta, const void* p, const void* trip,
                         void* out, int S, int B, int G, int K, int R, int ir,
                         int k_chunk, int threads, int smem_bytes,
                         void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + threads - 1) / threads;
  score_kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip, (float*)out, S,
      B, G, K, R, ir, k_chunk);
  return (int)cudaGetLastError();
}
