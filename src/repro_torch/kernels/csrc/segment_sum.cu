// Segment sum for Hopper (sm_90a): out[ids[n], :] += values[n, :].
//
// Replaces the TPU kernel repro/kernels/segment_reduce.py:_segsum_kernel,
// which builds a one-hot (block, S) matrix for each block of rows and runs
// P^T @ V on the MXU.  At word count's S ~ 21k segments that one-hot would
// be 43 MB per 512-row block, so the design is not carried over.
//
// What bounds it on the H100: bytes.  Each element is read once and added
// once, about one flop per 4 to 8 bytes, far below the ridge of the card's
// float32 rate against its 3.35 TB/s.  The one other limit is the L2's
// atomic unit, which serializes atomics on one address: one float32
// atomicAdd per element, the first version of this kernel, took 3.4 ms for
// 2.5M sorted Zipf ids whose hottest id holds a third of the rows.  So the
// design reads the rows once, coalesced, and issues an atomic only where a
// run of equal ids ends:
//
// * D == 1 (word count's shape): each thread reads a contiguous chunk of 4
//   or 8 rows, with vector loads where the chunk is whole and aligned and
//   scalar loads at the ragged head and tail, and sums each run of
//   equal ids inside its chunk in registers.  A segmented scan across the
//   warp's lanes (__shfl_up_sync, a run that starts in a lane as its head
//   flag) joins a run that crosses lanes, and the run's total is added
//   with one atomicAdd at the lane where it ends.  A warp walks several
//   consecutive 32-chunk spans and carries a run that crosses from one span
//   into the next, so a hot id costs one atomic per warp, not per row.
// * D > 1: a warp takes a span of rows and a tile of columns, its lanes run
//   across the columns (4 contiguous columns a lane with vector loads where
//   D and the base allow), and it walks the rows in order, adding each row
//   into registers and flushing one atomicAdd per column where the id
//   changes.
//
// Unsorted ids are runs of length one, so the same code takes any id order
// (one atomic per element, as before) without a flag or a second path.  Ids
// outside [0, S) form runs like any other id, so they break a run of valid
// ids, and are dropped at the flush: that is how the reference drops its
// padding id.  The order of the float32 sums changes from run to run where
// runs are split across lanes or warps; integer counts below 2^24 stay
// exact in any order.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/segment_reduce.py.  Each zero-fills `out` (S, D)
// float32 on the given stream, launches the kernel there unless N, D or S
// is 0, and returns the first CUDA error (0 on success).  The caller casts
// `out` to the input dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps a block
constexpr int kVec = 4;        // columns a lane reads, D > 1
constexpr int kUnroll = 4;     // rows loaded ahead, D > 1
// enough warps to keep the card's loads in flight: 132 SMs x 32 warps
constexpr int64_t kTargetWarps = 132 * 32;
constexpr int64_t kMinSpanRows = 32;  // rows a warp walks at least, D > 1

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void flush(float* out, int32_t id, int64_t s,
                                      float sum) {
  if (id >= 0 && static_cast<int64_t>(id) < s) atomicAdd(out + id, sum);
}

// R (4 or 8) values of one chunk from vector loads: float4s, or 16- or
// 8-byte words of bfloat16
template <int R>
__device__ __forceinline__ void load_values(const float* src, float (&v)[R]) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src) + q);
    v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
  }
}

template <int R>
__device__ __forceinline__ void load_values(const __nv_bfloat16* src,
                                            float (&v)[R]) {
  using Word = typename std::conditional<R % 8 == 0, uint4, uint2>::type;
  constexpr int kPer = sizeof(Word) / sizeof(__nv_bfloat16);
#pragma unroll
  for (int q = 0; q < R / kPer; ++q) {
    const Word raw = __ldg(reinterpret_cast<const Word*>(src) + q);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer / 2; ++j) {
      const float2 f = __bfloat1622float2(pairs[j]);
      v[q * kPer + 2 * j] = f.x;
      v[q * kPer + 2 * j + 1] = f.y;
    }
  }
}

// D == 1.  Chunk c holds rows [c * R - head, (c + 1) * R - head),
// where `head` (0-3) is the misalignment of `ids` in int32s: the ids of a
// whole chunk then start on a 16-byte boundary.  `vec_values` says whether
// the values of a whole chunk do too.  Rows outside [0, N) read as id -1,
// a run that is dropped.  Warp w walks chunks [w * iters * 32, (w + 1) *
// iters * 32), one 32-chunk span per iteration.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows_kernel(const T* __restrict__ values,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ out, int64_t n, int64_t s,
                        int head, int iters, bool vec_values) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  // the run that lane 31 of the previous span ended with: (id, sum so far)
  int32_t carry_id = -1;
  float carry = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const int64_t chunk = (warp * iters + it) * 32 + lane;
    const int64_t row0 = chunk * R - head;
    int32_t id[R];
    float v[R];
    if (row0 >= 0 && row0 + R <= n) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(ids + row0) + q);
        id[4 * q] = a.x; id[4 * q + 1] = a.y;
        id[4 * q + 2] = a.z; id[4 * q + 3] = a.w;
      }
      if (vec_values) {
        load_values<R>(values + row0, v);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) v[j] = to_f32(values[row0 + j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int64_t r = row0 + j;
        const bool in = r >= 0 && r < n;
        id[j] = in ? __ldg(ids + r) : -1;
        v[j] = in ? to_f32(values[r]) : 0.0f;
      }
    }
    // runs inside the chunk: the first (head) and the last (tail) may
    // continue in the neighbouring lanes; the ones between are whole
    int32_t cur = id[0];
    float sum = v[0];
    int32_t head_id = cur;
    float head_sum = 0.0f;
    bool single = true;
#pragma unroll
    for (int j = 1; j < R; ++j) {
      if (id[j] == cur) {
        sum += v[j];
      } else {
        if (single) {
          head_sum = sum;
          single = false;
        } else {
          flush(out, cur, s, sum);
        }
        cur = id[j];
        sum = v[j];
      }
    }
    if (single) head_sum = sum;
    const int32_t tail_id = cur;
    // does my head run continue the left lane's tail run (lane 0: the
    // carried run)?
    int32_t left_tail = __shfl_up_sync(kFull, tail_id, 1);
    if (lane == 0) left_tail = carry_id;
    const bool cont_left = head_id == left_tail;
    bool cont_right = __shfl_down_sync(kFull, cont_left, 1);
    if (lane == 31) cont_right = false;
    // segmented inclusive scan of the tail runs' sums: a lane whose whole
    // chunk continues the left lane's tail run joins its segment
    float x = sum;
    if (lane == 0 && single && cont_left) x += carry;
    bool starts = !(single && cont_left) || lane == 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float xl = __shfl_up_sync(kFull, x, off);
      const bool sl = __shfl_up_sync(kFull, starts, off);
      if (lane >= off && !starts) {
        x += xl;
        starts = sl;
      }
    }
    float left_x = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) {
      left_x = carry;
      if (!cont_left) flush(out, carry_id, s, carry);  // the carry ended
    }
    if (!single) flush(out, head_id, s, head_sum + (cont_left ? left_x : 0.0f));
    if (!cont_right && lane != 31) flush(out, tail_id, s, x);
    carry_id = __shfl_sync(kFull, tail_id, 31);
    carry = __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) flush(out, carry_id, s, carry);
}

// VEC values of one row starting at `src`, widened to float32
template <int VEC>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __ldg(src + j);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(pairs[0]);
    const float2 b = __bfloat1622float2(pairs[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __bfloat162float(src[j]);
  }
}

// D > 1.  Warp w of blockIdx.y's column tile walks rows [w * span, (w + 1)
// * span) in order; lane l holds columns tile * 32 * VEC + l * VEC + [0,
// VEC).  Each (run, column) inside the span gets one atomicAdd.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_cols_kernel(const T* __restrict__ values,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ out, int64_t n, int64_t d,
                        int64_t s, int64_t span) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * 32 + lane) * VEC;
  const int64_t lo = warp * span;
  const int64_t hi = lo + span < n ? lo + span : n;
  if (lo >= hi) return;  // the whole warp: no shuffles below
  const bool active = col < d;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  int32_t cur = __ldg(ids + lo);
  auto flush_row = [&](int32_t id) {
    if (active && id >= 0 && static_cast<int64_t>(id) < s) {
      float* dst = out + static_cast<int64_t>(id) * d + col;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (VEC == 1 || col + j < d) atomicAdd(dst + j, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  };
  for (int64_t r0 = lo; r0 < hi; r0 += kUnroll) {
    int32_t rid[kUnroll];
    float rv[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u;
      rid[u] = r < hi ? __ldg(ids + r) : cur;
#pragma unroll
      for (int j = 0; j < VEC; ++j) rv[u][j] = 0.0f;
      if (r < hi && active) load_vec<VEC>(values + r * d + col, rv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0 + u >= hi) break;
      if (rid[u] != cur) {
        flush_row(cur);
        cur = rid[u];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += rv[u][j];
    }
  }
  flush_row(cur);
}

template <typename T, int R>
int launch_rows(const T* values, const int32_t* ids, float* out, int64_t n,
                int64_t s, cudaStream_t stream) {
  const int head = static_cast<int>(
      (reinterpret_cast<uintptr_t>(ids) / sizeof(int32_t)) % 4);
  // whole chunks' values start at values + c * R - head: aligned for every
  // c where they are for c = 0
  constexpr uintptr_t kAlign = R * sizeof(T) < 16 ? R * sizeof(T) : 16;
  const bool vec_values = (reinterpret_cast<uintptr_t>(values) -
                           static_cast<uintptr_t>(head) * sizeof(T)) %
                              kAlign == 0;
  const int64_t chunks = (n + head + R - 1) / R;
  const int64_t spans = (chunks + 31) / 32;
  const int64_t iters =
      spans > kTargetWarps ? (spans + kTargetWarps - 1) / kTargetWarps : 1;
  const int64_t warps = (spans + iters - 1) / iters;
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  segment_sum_rows_kernel<T, R><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(values, ids, out, n, s, head,
                                            static_cast<int>(iters),
                                            vec_values);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* values, const int32_t* ids, float* out, int64_t n,
           int64_t d, int64_t s, cudaStream_t stream) {
  if (s > 0 && d > 0) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(s * d) * sizeof(float), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n <= 0 || d <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (d == 1) {
    // 4 rows a lane where the rows are few (latency-bound: more lanes in
    // flight), 8 where they are many (fewer spans, carries and scans)
    if ((n + 3) / 4 <= 32 * kTargetWarps)
      return launch_rows<T, 4>(values, ids, out, n, s, stream);
    return launch_rows<T, 8>(values, ids, out, n, s, stream);
  }
  // vector loads need every row start on a kVec-element boundary
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(values) % (kVec * sizeof(T)) == 0;
  const int64_t cols_per_tile = 32 * static_cast<int64_t>(vec ? kVec : 1);
  const int64_t tiles = (d + cols_per_tile - 1) / cols_per_tile;
  int64_t span = (n * tiles + kTargetWarps - 1) / kTargetWarps;
  if (span < kMinSpanRows) span = kMinSpanRows;
  const int64_t warps = (n + span - 1) / span;
  const dim3 grid(static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads),
                  static_cast<unsigned>(tiles));
  if (vec)
    segment_sum_cols_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
        values, ids, out, n, d, s, span);
  else
    segment_sum_cols_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        values, ids, out, n, d, s, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_sum_f32(const void* values, const void* ids, void* out,
                               int64_t n, int64_t d, int64_t s, void* stream) {
  return launch(static_cast<const float*>(values),
                static_cast<const int32_t*>(ids), static_cast<float*>(out), n,
                d, s, static_cast<cudaStream_t>(stream));
}

extern "C" int segment_sum_bf16(const void* values, const void* ids, void* out,
                                int64_t n, int64_t d, int64_t s, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(values),
                static_cast<const int32_t*>(ids), static_cast<float*>(out), n,
                d, s, static_cast<cudaStream_t>(stream));
}
