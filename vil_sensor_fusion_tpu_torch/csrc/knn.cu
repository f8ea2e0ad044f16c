// Exact masked 5-nearest-neighbour search for ICP correspondences (Hopper).
//
// Replaces the TPU kernel vil_sensor_fusion_tpu/ops/knn.py:_knn_kernel
// (launched by knn_pallas). Same result: for every query the k = 5 targets
// of smallest squared distance, ascending, lowest index first among equal
// distances, with masked targets at +inf.
//
// Distances use the same expanded form as the TPU kernel,
// ||q||^2 - 2 q.t + ||t||^2, in plain f32 on the CUDA cores. The contraction
// is 3 deep, so tensor cores would do no useful work: a 3-deep product is
// below the smallest wgmma depth, and TF32 would also lose sub-metre ranking
// at map coordinates. The kernel is bound by CUDA-core FMAs plus the
// compare-and-insert of the running top-5: about 22 M distance evaluations
// per sweep on the main path (192x1920 + 384x3984 + 1920x2048 + 3984x4096).
//
// Design (one block = QPB queries x LANES target lanes):
//   * targets are staged through shared memory as float4(x, y, z, ||t||^2),
//     with ||t||^2 = +inf for masked targets;
//   * thread (lane, qi) scans tile entries lane, lane + LANES, ... in
//     ascending index order and keeps a register top-5, inserting on strict
//     '<' so that an equal distance never displaces a lower index;
//   * the LANES partial lists of a query are merged by one thread with the
//     lexicographic order (distance, index).
// Ragged Q and M edges are bounds-checked; nothing is padded. Every returned
// index lies in [0, M): slots that find no valid target keep index 0 and
// distance +inf.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K = 5;
constexpr int LANES = 16;       // threads sharing one query
constexpr int QPB = 16;         // queries per block
constexpr int TILE = 2048;      // targets per shared-memory tile (32 KB)

__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K],
                                              float d, int idx) {
  // Callers present candidates so that a candidate equal in distance to a
  // stored entry is also higher in index, so strict '<' keeps ties in
  // index order. Descending sweep: slot s takes slot s-1's entry if the
  // candidate sorts before that entry, else the candidate itself.
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    if (d < bd[s]) {
      if (s > 0 && d < bd[s - 1]) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else {
        bd[s] = d;
        bi[s] = idx;
      }
    }
  }
}

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ void insert_lex(float (&bd)[K], int (&bi)[K],
                                           float d, int idx) {
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    if (lex_less(d, idx, bd[s], bi[s])) {
      if (s > 0 && lex_less(d, idx, bd[s - 1], bi[s - 1])) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else {
        bd[s] = d;
        bi[s] = idx;
      }
    }
  }
}

__global__ void __launch_bounds__(LANES * QPB)
knn5_kernel(const float* __restrict__ queries,   // (Q, 3)
            const float* __restrict__ targets,   // (M, 3)
            const float* __restrict__ t_mask,    // (M,)  > 0 = valid
            int Q, int M,
            int* __restrict__ out_idx,           // (Q, K)
            float* __restrict__ out_dist) {      // (Q, K)
  __shared__ float4 tile[TILE];
  __shared__ float part_d[QPB][LANES][K];
  __shared__ int part_i[QPB][LANES][K];

  const int lane = threadIdx.x;
  const int qi = threadIdx.y;
  const int tid = qi * LANES + lane;
  const int q = blockIdx.x * QPB + qi;
  const bool q_ok = q < Q;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q_ok) {
    qx = queries[3 * q + 0];
    qy = queries[3 * q + 1];
    qz = queries[3 * q + 2];
  }
  const float qsq = qx * qx + qy * qy + qz * qz;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  for (int base = 0; base < M; base += TILE) {
    const int n = min(TILE, M - base);
    __syncthreads();  // previous tile fully consumed
    for (int j = tid; j < n; j += LANES * QPB) {
      const int g = base + j;
      const float x = targets[3 * g + 0];
      const float y = targets[3 * g + 1];
      const float z = targets[3 * g + 2];
      const float tsq = t_mask[g] > 0.f ? x * x + y * y + z * z : CUDART_INF_F;
      tile[j] = make_float4(x, y, z, tsq);
    }
    __syncthreads();
    if (q_ok) {
      for (int j = lane; j < n; j += LANES) {
        const float4 t = tile[j];
        const float dot = qx * t.x + qy * t.y + qz * t.z;
        const float d = qsq - 2.f * dot + t.w;
        if (d < bd[K - 1]) insert_sorted(bd, bi, d, base + j);
      }
    }
  }

#pragma unroll
  for (int s = 0; s < K; ++s) {
    part_d[qi][lane][s] = bd[s];
    part_i[qi][lane][s] = bi[s];
  }
  __syncthreads();
  if (q_ok && lane == 0) {
    for (int l = 1; l < LANES; ++l) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        insert_lex(bd, bi, part_d[qi][l][s], part_i[qi][l][s]);
      }
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_idx[K * q + s] = bi[s];
      out_dist[K * q + s] = bd[s];
    }
  }
}

}  // namespace

// Plain-C entry point for ctypes. Launches on `stream` and returns the
// launch's cudaError_t (0 = success); never synchronises.
extern "C" int knn5_f32(const float* queries, const float* targets,
                        const float* t_mask, int Q, int M, int* out_idx,
                        float* out_dist, void* stream) {
  if (Q <= 0) return 0;
  const dim3 block(LANES, QPB);
  const dim3 grid((Q + QPB - 1) / QPB);
  knn5_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, targets, t_mask, Q, M, out_idx, out_dist);
  return static_cast<int>(cudaGetLastError());
}
