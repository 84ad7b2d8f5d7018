// Segment sum for Hopper (sm_90a): out[ids[n], :] += values[n, :].
//
// Replaces the TPU kernel repro/kernels/segment_reduce.py:_segsum_kernel,
// which builds a one-hot (block, S) matrix for each block of rows and runs
// P^T @ V on the MXU.  At word count's S ~ 21k segments that one-hot would
// be 43 MB per 512-row block, so the design is not carried over.
//
// What bounds it on the H100: bytes.  Each element is read once and added
// once, about one flop per 4 to 8 bytes, far below the ridge of the card's
// float32 rate against its 3.35 TB/s.  The design follows from that: one
// thread per (row, column) element, a grid-stride loop over N*D so that
// neighbouring threads read neighbouring values, and a float32 atomicAdd
// into the output, which L2 holds at the main path's sizes.  Atomics take
// any id order, and out-of-range ids are skipped, which is how the
// reference drops its padding id.  The order of the float32 sums changes
// from run to run; integer counts below 2^24 stay exact in any order.
// A later version reduces sorted runs inside a warp first and issues
// atomics only at run boundaries.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/segment_reduce.py.  Each returns cudaGetLastError()
// after its launch; the caller zero-fills `out` (S, D) in float32 and
// casts it to the input dtype afterwards.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ values,
                                   const int32_t* __restrict__ ids,
                                   float* __restrict__ out, int64_t n,
                                   int64_t d, int64_t s) {
  const int64_t total = n * d;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    // d == 1 is word count's shape: skip the 64-bit division there
    const int64_t row = d == 1 ? e : e / d;
    const int64_t col = e - row * d;
    const int32_t id = __ldg(ids + row);
    if (id < 0 || static_cast<int64_t>(id) >= s) continue;
    atomicAdd(out + static_cast<int64_t>(id) * d + col, to_f32(values[e]));
  }
}

template <typename T>
int launch(const T* values, const int32_t* ids, float* out, int64_t n,
           int64_t d, int64_t s, cudaStream_t stream) {
  const int64_t total = n * d;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      values, ids, out, n, d, s);
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
