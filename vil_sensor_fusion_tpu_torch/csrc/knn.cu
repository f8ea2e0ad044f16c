// Exact masked 5-nearest-neighbour search for ICP correspondences (Hopper).
//
// Replaces the TPU kernel vil_sensor_fusion_tpu/ops/knn.py:_knn_kernel
// (launched by knn_pallas). Same result: for every query the k = 5 targets
// of smallest squared distance, ascending, lowest index first among equal
// distances, masked targets at +inf; a slot that finds no valid target
// holds index 0 and +inf, so every index lies in [0, M).
//
// Distances use the TPU kernel's expanded form ||q||^2 - 2 q.t + ||t||^2 in
// plain f32 on the CUDA cores, rounded as written (sq3, dist2): 8 FLOP per
// (query, target) pair. The contraction is 3 deep, below the smallest
// wgmma depth, and TF32 would lose sub-metre ranking at map coordinates,
// so tensor cores do no useful work. Bound: 8 Q M FLOP at 67 TFLOP/s (f32,
// H100 SXM), compute-bound at every main-path shape (3984 x 4096: 1.95
// us); the bytes, 12 Q + 16 M + 40 Q, take under 0.1 us at 3.35 TB/s.
//
// Design. One launch per call, grid = (target splits, query tiles), 256
// threads; each warp owns R = 1 or 2 queries. The host plans R and the
// split count (ops/knn.py:_plan) for about two blocks per SM. Query tiles
// sit in grid.y, so a call takes at most 65,535 of them (Q <= 1,048,560 at
// R = 2); the wrapper refuses more, and its ticket buffer has one entry
// per tile the grid can hold.
//   * Staging: each block copies its contiguous target split in tiles of
//     up to 1,024 targets with cp.async (16 bytes a thread where aligned)
//     and folds them into float4(x, y, z, ||t||^2, or +inf if masked). The
//     copy of the next tile overlaps the work on the current one.
//   * Bound: on the split's first tile each lane takes its smallest
//     distance per query; the warp's 5th smallest of those bounds the
//     query's 5th-nearest distance in the split from above. (Tightening
//     it after each further tile to the warp's 5th nearest so far cost
//     more than the inserts it saved.)
//   * Scan: lane l takes targets l, l + 32, ... of the tile; per pair 3
//     FMAs for q.t, one FMA, one add and one compare, with no branch: the
//     lane sets a bit for each target within the bound. Each staged target
//     is read once for the warp's R queries.
//   * Insert: after the tile the lane inserts its noted targets (a few)
//     into its 5 smallest keys per query. (Inserting as the scan goes
//     made the whole warp wait on the branch nearly every step.)
//   * Keys: (distance, index) packs into one 64-bit key, the distance's
//     bits made order-preserving (-0 as +0, negatives bit-flipped:
//     cancellation at 100 m gives small negative distances) above the
//     index, so the order is one integer compare and total: the result
//     does not depend on the order of inserts or on which lane, warp or
//     block finishes first. A warp's 32 lists merge by 5 rounds of
//     xor-shuffle minimum extraction.
//     With several splits each block writes its 5 keys per query to
//     scratch; the last block of a query tile to finish (an atomic ticket
//     after a __threadfence) merges the splits' lists the same way, writes
//     idx / dist and resets the ticket for the next launch.
// Ragged Q and M edges are bounds-checked; nothing is padded in device
// memory.
//
// Resources (ptxas, sm_90a, -O3, CUDA 12.8): R = 1 76 registers, R = 2 96
// registers, no spills; shared memory per block 34,816 bytes dynamic (a
// 1,024-target tile, folded and raw) and 16 bytes static.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

typedef unsigned long long u64;

constexpr int K = 5;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;      // a warp owns R queries
constexpr int UNROLL = 4;                // targets per lane per step
constexpr int STEP = 32 * UNROLL;        // targets per warp per step
constexpr int TILE = 1024;               // targets per shared-memory tile
static_assert(TILE / 32 <= 32, "a lane notes its hits in a tile in 32 bits");
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 FILL = 0xFF80000000000000ull;  // key of (+inf, index 0)

__device__ __forceinline__ unsigned order_bits(float d) {
  unsigned u = __float_as_uint(d);
  if ((u << 1) == 0u) u = 0u;  // -0 -> +0: both tie, lower index first
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorder_bits(unsigned h) {
  return __uint_as_float((h & 0x80000000u) ? (h ^ 0x80000000u) : ~h);
}

__device__ __forceinline__ u64 pack(float d, int i) {
  return (static_cast<u64>(order_bits(d)) << 32) | static_cast<unsigned>(i);
}

__device__ __forceinline__ float key_dist(u64 k) {
  return unorder_bits(static_cast<unsigned>(k >> 32));
}

// Insert a key into the ascending list, without branches: every slot's
// compare reads the old list, so the five are independent. Slot s takes
// slot s-1's key if the candidate sorts before it, else the candidate if
// it sorts before slot s's. Keys are a total order, so the order in which
// candidates arrive does not change the list.
__device__ __forceinline__ void insert_key(u64 (&k)[K], u64 c) {
  bool lt[K];
#pragma unroll
  for (int s = 0; s < K; ++s) lt[s] = c < k[s];
#pragma unroll
  for (int s = K - 1; s > 0; --s)
    k[s] = lt[s - 1] ? k[s - 1] : (lt[s] ? c : k[s]);
  k[0] = lt[0] ? c : k[0];
}

// The 5 smallest keys of the warp's 32 sorted lists, per query, in every
// lane: 5 rounds of a warp-wide minimum by xor shuffles (the R queries'
// rounds interleaved); the lane holding it pops its head. Keys of valid
// targets are unique; FILL sorts after all of them.
template <int R>
__device__ __forceinline__ void warp_merge(u64 (&k)[R][K],
                                           u64 (&out)[R][K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    u64 m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = k[r][0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const u64 o = __shfl_xor_sync(FULL, m[r], off);
        m[r] = o < m[r] ? o : m[r];
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      out[r][s] = m[r];
      if (k[r][0] == m[r]) {
#pragma unroll
        for (int j = 0; j < K - 1; ++j) k[r][j] = k[r][j + 1];
        k[r][K - 1] = FILL;
      }
    }
  }
}

// In place, per query: the 5th smallest of the warp's 32 values (or more
// than the 5th if values repeat: equal minima are taken together), in
// every lane.
template <int R>
__device__ __forceinline__ void warp_fifth_min(float (&m)[R]) {
  float v[R];
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = m[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = fminf(v[r], __shfl_xor_sync(FULL, v[r], off));
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (m[r] == v[r]) m[r] = CUDART_INF_F;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = v[r];
}

// A lane's next UNROLL targets of the tile: j0, j0 + 32, ... (the tile is
// padded with targets at +inf to a whole step, and one step more that the
// prefetch may read and nobody uses).
__device__ __forceinline__ void load_targets(const float4* folded, int j0,
                                             float4 (&t)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) t[u] = folded[j0 + 32 * u];
}

// Lane r * 5 + s writes slot s of the warp's query r.
template <int R>
__device__ __forceinline__ void write_out(int q0, int Q, int lane,
                                          const u64 (&res)[R][K],
                                          int* out_idx, float* out_dist) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (lane == r * K + s && q0 + r < Q) {
        out_idx[K * (q0 + r) + s] = static_cast<int>(res[r][s] & 0xffffffffu);
        out_dist[K * (q0 + r) + s] = key_dist(res[r][s]);
      }
    }
  }
}

// The arithmetic of the distance, rounded as written (explicit intrinsics:
// the compiler may not contract it differently in each instantiation, so
// every grid shape gives the same bits).
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float qsq, float4 t) {
  const float dot = __fmaf_rn(qz, t.z, __fmaf_rn(qy, t.y, __fmul_rn(qx, t.x)));
  return __fadd_rn(__fmaf_rn(-2.f, dot, qsq), t.w);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int R>
__global__ void __launch_bounds__(THREADS)
knn5_kernel(const float* __restrict__ queries,   // (Q, 3)
            const float* __restrict__ targets,   // (M, 3)
            const float* __restrict__ t_mask,    // (M,)  > 0 = valid
            int Q, int M, int split_len,
            int* __restrict__ out_idx,           // (Q, K)
            float* __restrict__ out_dist,        // (Q, K)
            u64* __restrict__ scratch,           // (Q, splits, K)
            unsigned* __restrict__ tickets) {    // (query tiles,), zeroed
  extern __shared__ float4 smem[];
  const int cap = min(TILE, split_len);
  const int padded = (cap + STEP - 1) / STEP * STEP + STEP;
  float4* folded = smem;                                 // (padded,)
  float* raw = reinterpret_cast<float*>(smem + padded);  // xyz (3 cap), mask

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int q0 = blockIdx.y * (WARPS * R) + (tid / 32) * R;
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int t_begin = split * split_len;
  const int t_end = min(M, t_begin + split_len);

  // Copy `count` words to shared memory: 16 bytes a thread where both
  // ends are 16-byte aligned, 4 bytes for the rest.
  auto copy = [&](float* dst, const float* src, int count) {
    int j = tid;
    if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
         15) == 0) {
      for (; 4 * j + 3 < count; j += THREADS)
        cp_async16(dst + 4 * j, src + 4 * j);
      j = (count & ~3) + tid;
    }
    for (; j < count; j += THREADS) cp_async4(dst + j, src + j);
  };
  auto stage = [&](int base) {  // async copy of one tile's raw words
    const int n = min(cap, t_end - base);
    copy(raw, targets + 3 * static_cast<size_t>(base), 3 * n);
    copy(raw + 3 * cap, t_mask + base, n);
    cp_async_commit();
  };
  stage(t_begin);

  // The warp's R queries. Each lane keeps the 5 smallest keys per query
  // of the targets it scans (l, l + 32, ... of each tile).
  float qx[R], qy[R], qz[R], qsq[R];
  u64 kk[R][K];
  float lim[R];  // one ulp above the bound: d <= bound iff d < lim
  float thr[R];  // min(lim, own 5th best): a target is inserted iff d < thr
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = min(q0 + r, Q - 1);  // rows past Q are computed, not kept
    qx[r] = queries[3 * q + 0];
    qy[r] = queries[3 * q + 1];
    qz[r] = queries[3 * q + 2];
    qsq[r] = sq3(qx[r], qy[r], qz[r]);
#pragma unroll
    for (int s = 0; s < K; ++s) kk[r][s] = FILL;
  }

  for (int base = t_begin; base < t_end; base += cap) {
    const int n = min(cap, t_end - base);
    cp_async_wait_all();
    __syncthreads();  // raw tile landed; the previous scan is done
    for (int j = tid; j < (n + STEP - 1) / STEP * STEP; j += THREADS) {
      float4 v = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
      if (j < n) {
        v.x = raw[3 * j + 0];
        v.y = raw[3 * j + 1];
        v.z = raw[3 * j + 2];
        if (raw[3 * cap + j] > 0.f) v.w = sq3(v.x, v.y, v.z);
      }
      folded[j] = v;
    }
    __syncthreads();  // folded tile ready; raw buffer free
    if (base + cap < t_end) stage(base + cap);  // overlaps the scans below
    if (base == t_begin) {
      // Bound, from the split's first tile: each lane's smallest distance
      // over its share; the warp's 5th smallest such minimum lies at or
      // above the query's 5th-nearest distance in the split (5 distinct
      // targets lie at or below it), so a target further than the bound
      // cannot be among the 5. Ties with the bound are kept: the merge
      // orders them by index.
      float m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) m[r] = CUDART_INF_F;
      float4 t[UNROLL];
      load_targets(folded, lane, t);
      for (int j0 = lane; j0 < n; j0 += STEP) {
        float4 next[UNROLL];
        load_targets(folded, j0 + STEP, next);  // in flight meanwhile
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int r = 0; r < R; ++r)
            m[r] = fminf(m[r], dist2(qx[r], qy[r], qz[r], qsq[r], t[u]));
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) t[u] = next[u];
      }
      warp_fifth_min(m);
#pragma unroll
      for (int r = 0; r < R; ++r)
        thr[r] = lim[r] = nextafterf(m[r], CUDART_INF_F);
    }
    // Scan, without branches: a lane notes which of its targets fall
    // within its threshold (bit it * UNROLL + u of hits[r] for target
    // j0 + 32 u of step it; a tile has at most 32 such per lane). With the
    // bound in hand these are few.
    unsigned hits[R];
#pragma unroll
    for (int r = 0; r < R; ++r) hits[r] = 0u;
    float4 t[UNROLL];
    load_targets(folded, lane, t);
    for (int j0 = lane, bit = 0; j0 < n; j0 += STEP, bit += UNROLL) {
      float4 next[UNROLL];
      load_targets(folded, j0 + STEP, next);  // in flight meanwhile
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          hits[r] |= static_cast<unsigned>(
                         dist2(qx[r], qy[r], qz[r], qsq[r], t[u]) < thr[r])
                     << (bit + u);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) t[u] = next[u];
    }
    // Insert the noted targets.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (unsigned h = hits[r]; h != 0u; h &= h - 1u) {
        const int b = __ffs(h) - 1;
        const int j = (b / UNROLL) * STEP + lane + 32 * (b % UNROLL);
        const float d = dist2(qx[r], qy[r], qz[r], qsq[r], folded[j]);
        if (d < thr[r]) {
          insert_key(kk[r], pack(d, base + j));
          thr[r] = fminf(lim[r], key_dist(kk[r][K - 1]));
        }
      }
    }
  }

  // The 5 nearest of the warp's 32 lists, per query.
  u64 res[R][K];
  warp_merge(kk, res);
  if (n_splits == 1) {
    write_out(q0, Q, lane, res, out_idx, out_dist);
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (lane == r * K + s && q < Q)
        scratch[(static_cast<size_t>(q) * n_splits + split) * K + s] =
            res[r][s];
    }
  }
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&tickets[blockIdx.y], 1u) == n_splits - 1u;
    if (last) tickets[blockIdx.y] = 0u;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last block of this query tile merges every split's list: lane l
  // keeps the smallest 5 of keys l, l + 32, ... of the query's splits *
  // 5, then the warp takes the 5 smallest of its 32 lists.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const u64* src =
        scratch + static_cast<size_t>(min(q0 + r, Q - 1)) * n_splits * K;
#pragma unroll
    for (int s = 0; s < K; ++s) kk[r][s] = FILL;
    for (int i = lane; i < n_splits * K; i += 32)
      insert_key(kk[r], __ldcg(src + i));
  }
  warp_merge(kk, res);
  write_out(q0, Q, lane, res, out_idx, out_dist);
}

}  // namespace

// Plain-C entry point for ctypes. `rows` = queries per warp (R), the grid
// is (n_splits, ceil(Q / (8 R))), at most 65,535 query tiles; `scratch`
// and `tickets` are read only when n_splits > 1 (one ticket per query
// tile, zeroed before the first launch; the kernel leaves them zeroed). Launches on `stream` and returns the launch's
// cudaError_t (0 = success); never synchronises.
extern "C" int knn5_f32(const float* queries, const float* targets,
                        const float* t_mask, int Q, int M, int rows,
                        int n_splits, int split_len, int* out_idx,
                        float* out_dist, u64* scratch, unsigned* tickets,
                        void* stream) {
  if (Q <= 0) return 0;
  if (M <= 0 || n_splits <= 0 || split_len <= 0 ||
      static_cast<long long>(n_splits - 1) * split_len >= M ||
      static_cast<long long>(n_splits) * split_len < M)
    return static_cast<int>(cudaErrorInvalidValue);  // empty or missing split
  const int q_tile = WARPS * rows;
  const dim3 grid(n_splits, (Q + q_tile - 1) / q_tile);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = min(TILE, split_len);
  const size_t smem =
      sizeof(float4) * ((cap + STEP - 1) / STEP * STEP + STEP + cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 1)
    knn5_kernel<1><<<grid, THREADS, smem, s>>>(queries, targets, t_mask, Q,
                                               M, split_len, out_idx,
                                               out_dist, scratch, tickets);
  else if (rows == 2)
    knn5_kernel<2><<<grid, THREADS, smem, s>>>(queries, targets, t_mask, Q,
                                               M, split_len, out_idx,
                                               out_dist, scratch, tickets);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
