// MoE token dispatch for Hopper (sm_90a):
//   out[expert_ids[t], slot_ids[t], :] += tokens[t, :]
// for every row t whose expert id lies in [0, E) and whose slot lies in
// [0, C); every other row is dropped (capacity overflow, padding).
//
// Replaces the TPU kernel repro/kernels/moe_dispatch.py:_dispatch_kernel,
// which for each (expert, token block) grid cell builds the one-hot
// (C, block) matrix P[c, n] = (id[n] == e) & (slot[n] == c) and adds
// P @ tokens into the expert's VMEM-resident (C, D) buffer.  At Granite's
// 3000-token prefill that is E * C * T * D = 40 * 750 * 24000 * 1536
// multiply-adds for 24000 * 1536 useful ones, so the design is not carried
// over.  What the TPU kernel computes is kept: rows that share an (expert,
// slot) pair are summed (the MoE layer clamps a kept token's slot to C-1
// when a planned capacity exceeds C, so pairs do repeat), the sums are
// float32, and the caller casts them to the tokens' dtype.
//
// What bounds it on the H100: bytes.  Each kept element is read once and
// added once; the (T, D) rows in and the (E, C, D) buffers out are the
// whole of the traffic.  The design: one block per token row (a
// grid-stride loop over rows), whose threads read the row with 16-byte
// vector loads (4 float32 or 8 bfloat16 values each) and add each value
// into the float32 buffer with one atomicAdd.  The block reads its row's
// (expert, slot) pair once and skips a dropped row whole.  Atomics take
// any row order and sum repeated pairs; where every pair is unique, one
// float32 add onto zero is exact, so the result equals the plain version
// bit for bit.  Where pairs repeat, the order of the float32 sums changes
// from run to run.  A later version writes unique pairs directly in the
// tokens' dtype, without the float32 staging buffer and the cast.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/moe_dispatch.py.  Each returns cudaGetLastError()
// after its launch; the caller zero-fills `out` (E, C, D) in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

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
  if constexpr (VEC == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(pairs[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __bfloat162float(src[j]);
  }
}

template <typename T, int VEC>
__global__ void moe_dispatch_kernel(const T* __restrict__ tokens,
                                    const int32_t* __restrict__ expert_ids,
                                    const int32_t* __restrict__ slot_ids,
                                    float* __restrict__ out, int64_t t,
                                    int64_t d, int64_t e, int64_t c) {
  for (int64_t row = blockIdx.x; row < t; row += gridDim.x) {
    const int32_t ex = __ldg(expert_ids + row);
    const int32_t sl = __ldg(slot_ids + row);
    // the same pair for the whole block: a dropped row is skipped whole
    if (ex < 0 || static_cast<int64_t>(ex) >= e || sl < 0 ||
        static_cast<int64_t>(sl) >= c)
      continue;
    const T* src = tokens + row * d;
    float* dst = out + (static_cast<int64_t>(ex) * c + sl) * d;
    for (int64_t col = static_cast<int64_t>(threadIdx.x) * VEC; col < d;
         col += static_cast<int64_t>(blockDim.x) * VEC) {
      float v[VEC];
      load_vec<VEC>(src + col, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) atomicAdd(dst + col + j, v[j]);
    }
  }
}

template <typename T, int VEC>
int launch_vec(const T* tokens, const int32_t* expert_ids,
               const int32_t* slot_ids, float* out, int64_t t, int64_t d,
               int64_t e, int64_t c, cudaStream_t stream) {
  // enough warps for one pass over the row, at most kMaxThreads
  const int64_t vecs = (d + VEC - 1) / VEC;
  int64_t threads = (vecs + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int64_t blocks = t < kMaxBlocks ? t : kMaxBlocks;
  moe_dispatch_kernel<T, VEC>
      <<<static_cast<unsigned>(blocks), static_cast<unsigned>(threads), 0,
         stream>>>(tokens, expert_ids, slot_ids, out, t, d, e, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* tokens, const int32_t* expert_ids, const int32_t* slot_ids,
           float* out, int64_t t, int64_t d, int64_t e, int64_t c,
           cudaStream_t stream) {
  if (t <= 0 || d <= 0 || e <= 0 || c <= 0)
    return static_cast<int>(cudaSuccess);
  // 16-byte loads need every row start on a 16-byte boundary
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(tokens) % 16 == 0 &&
                       d % kVec == 0;
  if (aligned)
    return launch_vec<T, kVec>(tokens, expert_ids, slot_ids, out, t, d, e, c,
                               stream);
  return launch_vec<T, 1>(tokens, expert_ids, slot_ids, out, t, d, e, c,
                          stream);
}

}  // namespace

extern "C" int moe_dispatch_f32(const void* tokens, const void* expert_ids,
                                const void* slot_ids, void* out, int64_t t,
                                int64_t d, int64_t e, int64_t c,
                                void* stream) {
  return launch(static_cast<const float*>(tokens),
                static_cast<const int32_t*>(expert_ids),
                static_cast<const int32_t*>(slot_ids), static_cast<float*>(out),
                t, d, e, c, static_cast<cudaStream_t>(stream));
}

extern "C" int moe_dispatch_bf16(const void* tokens, const void* expert_ids,
                                 const void* slot_ids, void* out, int64_t t,
                                 int64_t d, int64_t e, int64_t c,
                                 void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(tokens),
                static_cast<const int32_t*>(expert_ids),
                static_cast<const int32_t*>(slot_ids), static_cast<float*>(out),
                t, d, e, c, static_cast<cudaStream_t>(stream));
}
