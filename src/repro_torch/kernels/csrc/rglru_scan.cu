// RG-LRU gated linear recurrence for Hopper (sm_90a), RecurrentGemma's
// recurrent block:
//
//     h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,   h_{-1} = h0 or 0
//
// returning every h_t (in x's dtype) and the last one (float32).
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py:_rglru_kernel, which
// runs a log-depth associative scan inside a VMEM chunk of time steps and
// carries the state between chunks along a sequential grid axis.
//
// What bounds it on the H100: bytes.  Each step reads x and a and writes y
// once, with 4 operations per element; at the served prefill (B=1, T=3000,
// D=4096, bfloat16) that is about 74 MB, 0.022 ms at 3.35 TB/s.  This first
// kernel is one thread per (batch, channel) walking t in order with h in a
// float32 register: neighbouring threads take neighbouring channels, so
// every load and store of a warp is one coalesced row segment, and each
// thread loads the next kUnroll steps of x and a before it computes them, so
// that those loads are in flight together.  It is far from the bound: with
// B*D = 4096 threads the card holds a few warps per SM, and each walks a
// dependent chain of length T.  A chunked scan (per-chunk local scans in
// parallel, then the carries) is the work of a later PR.  There is no
// padding: the loop ends at T exactly, so the TPU kernel's a = 1 padding
// rule (rglru_scan.py:72-74) is not needed.
//
// Layout: x, a and y (B, T, D), h0 and hT (B, D), contiguous.  x, a and y
// share one dtype, float32 or bfloat16; h0 (optional, may be null) and hT
// are float32.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/rglru_scan.py.  Each returns cudaGetLastError() after
// its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;  // one warp per block spreads B*D over the SMs
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ h_t, int64_t b_len, int64_t t_len,
                  int64_t d_len) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (d >= d_len) return;
  const int64_t base = b * t_len * d_len + d;
  float h = h0 ? h0[b * d_len + d] : 0.f;
  for (int64_t t0 = 0; t0 < t_len; t0 += kUnroll) {
    float xs[kUnroll], as[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = t0 + u < t_len;
      const int64_t off = base + (t0 + u) * d_len;
      xs[u] = in ? to_f32(x[off]) : 0.f;
      as[u] = in ? to_f32(a[off]) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= t_len) break;
      const float at = as[u];
      h = at * h + sqrtf(fmaxf(1.f - at * at, 0.f)) * xs[u];
      store(y + base + (t0 + u) * d_len, h);
    }
  }
  h_t[b * d_len + d] = h;
}

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* y, void* h_t,
           int64_t b, int64_t t, int64_t d, void* stream) {
  if (b <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  rglru_scan_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_t), b, t, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rglru_scan_f32(const void* x, const void* a, const void* h0,
                              void* y, void* h_t, int64_t b, int64_t t,
                              int64_t d, void* stream) {
  return launch<float>(x, a, h0, y, h_t, b, t, d, stream);
}

extern "C" int rglru_scan_bf16(const void* x, const void* a, const void* h0,
                               void* y, void* h_t, int64_t b, int64_t t,
                               int64_t d, void* stream) {
  return launch<__nv_bfloat16>(x, a, h0, y, h_t, b, t, d, stream);
}
