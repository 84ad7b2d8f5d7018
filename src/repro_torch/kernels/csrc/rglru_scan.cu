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
// once, with about 7 operations per element; at the served prefill (B=1,
// T=3000, D=4096, bfloat16) that is about 74 MB, 0.022 ms at 3.35 TB/s.
// One thread per (batch, channel) walking all of T is latency-bound
// instead: 4096 threads fill under a warp per SM, and each waits on its
// loads every few steps.
//
// Design: a chunked scan in two launches, without atomics.  Time is cut
// into K chunks of `chunk` steps (the wrapper picks K so that the blocks
// fill the SMs several times over).  A chunk maps the state that enters it,
// h_in, to A_c * h_in + H_c, where A_c is the product of its a_t and H_c its
// state from h = 0.
//
//   1. rglru_scan_summary_kernel, grid (channel tiles of kThreads, K - 1, B):
//      each thread walks its channel through one chunk and writes (A_c, H_c)
//      to a float32 scratch (2, B, K - 1, D).  The last chunk's pair is
//      never needed.
//   2. rglru_scan_output_kernel, the same grid with K chunks: each thread
//      folds the pairs of the chunks before its own into h_in, starting from
//      h0, rescans its chunk from there and writes y, and h_T from the last
//      chunk.
//
// Neighbouring threads take neighbouring channels, so every load and store
// of a warp is one coalesced row segment, and a thread loads kUnroll steps
// of x and a before it computes them, so that those loads are in flight
// together.  Loads guarded one by one compile to a branch each and ran the
// passes at half the speed: every chunk but the last is a whole number of
// groups, loaded unguarded.  x and a are read twice (~123 MB at the served prefill against
// the 74 MB bound); the second read may partly hit the 50 MB L2.  At T = 1
// (a decode step) K is 1: one launch of pass 2, no scratch.  There is no
// padding: each chunk ends at its last step exactly, so the TPU kernel's
// a = 1 padding rule (rglru_scan.py:72-74) is not needed.
//
// Layout: x, a and y (B, T, D), h0 and hT (B, D), contiguous.  x, a and y
// share one dtype, float32 or bfloat16; h0 (optional, may be null), hT and
// the scratch are float32.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/rglru_scan.py.  Each scan entry returns
// cudaGetLastError() after its last launch; rglru_scan_geometry gives the
// wrapper's chunking the constants below, so that they are set here only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kMinBlocks = 8;  // blocks an SM holds: registers for 8 x 128
constexpr int kUnroll = 8;     // steps whose loads are in flight together
constexpr int kFold = 8;       // chunk pairs loaded together by pass 2

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* x;
  const void* a;
  const float* h0;
  void* y;
  float* h_t;
  float* scratch;  // (2, B, K - 1, D): A_c, then H_c
  int64_t b_len, t_len, d_len, chunk, n_chunks;
};

// One step of the recurrence; multiplies `prod` by a_t when kProduct,
// stores h_t into y when y is not null.  a_t^2 is rounded before 1 - a_t^2,
// as the reference computes it: contracted into one FMA, it differs near
// a = 1, where the subtraction cancels, by up to 4e-4 of sqrt's argument,
// and over thousands of steps by more than float32's tolerance.
template <typename T, bool kProduct>
__device__ __forceinline__ float step(float h, float at, float xt, float& prod,
                                      T* y) {
  h = at * h + sqrtf(fmaxf(1.f - __fmul_rn(at, at), 0.f)) * xt;
  if (kProduct) prod *= at;
  if (y) store(y, h);
  return h;
}

// Walk steps [t0, t1) of one channel from h: whole groups of kUnroll steps
// with their loads issued together and unguarded, then the rest as one
// guarded group (the wrapper makes every chunk but the last a whole number
// of groups).
template <typename T, bool kProduct>
__device__ __forceinline__ float walk(const T* __restrict__ x,
                                      const T* __restrict__ a,
                                      T* __restrict__ y, int64_t d_len,
                                      int64_t t0, int64_t t1, float h,
                                      float& prod) {
  int64_t s = t0;
  for (; s + kUnroll <= t1; s += kUnroll) {
    const T* xp = x + s * d_len;
    const T* ap = a + s * d_len;
    float xs[kUnroll], as[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xs[u] = to_f32(xp[u * d_len]);
      as[u] = to_f32(ap[u * d_len]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      h = step<T, kProduct>(h, as[u], xs[u], prod,
                            y ? y + (s + u) * d_len : nullptr);
  }
  if (s < t1) {
    float xs[kUnroll], as[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = s + u < t1;
      xs[u] = in ? to_f32(x[(s + u) * d_len]) : 0.f;
      as[u] = in ? to_f32(a[(s + u) * d_len]) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u >= t1) break;
      h = step<T, kProduct>(h, as[u], xs[u], prod, y ? y + (s + u) * d_len
                                                     : nullptr);
    }
  }
  return h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rglru_scan_summary_kernel(Args args) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t k = blockIdx.y, b = blockIdx.z;
  if (d >= args.d_len) return;
  const int64_t base = b * args.t_len * args.d_len + d;
  const int64_t t0 = k * args.chunk;
  const int64_t t1 = t0 + args.chunk;  // chunk k < K - 1 is whole
  float prod = 1.f;
  const float h = walk<T, true>(static_cast<const T*>(args.x) + base,
                                static_cast<const T*>(args.a) + base,
                                nullptr, args.d_len, t0, t1, 0.f, prod);
  const int64_t pairs = args.b_len * (args.n_chunks - 1) * args.d_len;
  const int64_t at = (b * (args.n_chunks - 1) + k) * args.d_len + d;
  args.scratch[at] = prod;
  args.scratch[pairs + at] = h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rglru_scan_output_kernel(Args args) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t k = blockIdx.y, b = blockIdx.z;
  if (d >= args.d_len) return;
  float h = args.h0 ? args.h0[b * args.d_len + d] : 0.f;
  // fold the chunks before this one: h = A_j * h + H_j, in chunk order
  const int64_t pairs = args.b_len * (args.n_chunks - 1) * args.d_len;
  const float* pa = args.scratch + b * (args.n_chunks - 1) * args.d_len + d;
  for (int64_t j0 = 0; j0 < k; j0 += kFold) {
    float as[kFold], hs[kFold];
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      const bool in = j0 + u < k;
      as[u] = in ? pa[(j0 + u) * args.d_len] : 1.f;
      hs[u] = in ? pa[pairs + (j0 + u) * args.d_len] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      if (j0 + u >= k) break;
      h = as[u] * h + hs[u];
    }
  }
  const int64_t base = b * args.t_len * args.d_len + d;
  const int64_t t0 = k * args.chunk;
  const int64_t t1 = t0 + args.chunk < args.t_len ? t0 + args.chunk : args.t_len;
  float unused = 1.f;
  h = walk<T, false>(static_cast<const T*>(args.x) + base,
                     static_cast<const T*>(args.a) + base,
                     static_cast<T*>(args.y) + base, args.d_len, t0, t1, h,
                     unused);
  if (k == args.n_chunks - 1) args.h_t[b * args.d_len + d] = h;
}

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* y, void* h_t,
           void* scratch, int64_t b, int64_t t, int64_t d, int64_t chunk,
           void* stream) {
  if (b <= 0 || d <= 0 || t <= 0) return static_cast<int>(cudaSuccess);
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_chunks = (t + chunk - 1) / chunk;
  if (n_chunks > 65535 || b > 65535 || (n_chunks > 1 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, a, static_cast<const float*>(h0), y,
                  static_cast<float*>(h_t), static_cast<float*>(scratch),
                  b, t, d, chunk, n_chunks};
  const unsigned tiles = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 1) {
    rglru_scan_summary_kernel<T>
        <<<dim3(tiles, static_cast<unsigned>(n_chunks - 1),
                static_cast<unsigned>(b)),
           kThreads, 0, s>>>(args);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_scan_output_kernel<T>
      <<<dim3(tiles, static_cast<unsigned>(n_chunks), static_cast<unsigned>(b)),
         kThreads, 0, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[0]: channels a block; out[1]: steps whose loads a thread issues
// together (a chunk of a whole number of them is walked unguarded);
// out[2]: blocks an SM holds at once
extern "C" void rglru_scan_geometry(int64_t* out) {
  out[0] = kThreads;
  out[1] = kUnroll;
  out[2] = kMinBlocks;
}

// chunk: steps per chunk; scratch: 2 * b * (ceil(t / chunk) - 1) * d floats,
// or null when one chunk covers t
extern "C" int rglru_scan_f32(const void* x, const void* a, const void* h0,
                              void* y, void* h_t, void* scratch, int64_t b,
                              int64_t t, int64_t d, int64_t chunk,
                              void* stream) {
  return launch<float>(x, a, h0, y, h_t, scratch, b, t, d, chunk, stream);
}

extern "C" int rglru_scan_bf16(const void* x, const void* a, const void* h0,
                               void* y, void* h_t, void* scratch, int64_t b,
                               int64_t t, int64_t d, int64_t chunk,
                               void* stream) {
  return launch<__nv_bfloat16>(x, a, h0, y, h_t, scratch, b, t, d, chunk,
                               stream);
}
