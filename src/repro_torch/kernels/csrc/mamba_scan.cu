// Mamba-1 selective scan for Hopper (sm_90a), Falcon-Mamba's mixer:
//
//     h_t = exp(delta_t * A) * h_{t-1} + (delta_t * x_t) * B_t,   h_{-1} = h0 or 0
//     y_t = sum_s h_t[s] * C_t[s] + D * x_t
//
// per (batch, channel), with h_t a vector over the d_state axis; returns
// every y_t (in x's dtype) and the last state h_T (float32).
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py:_mamba_kernel, which
// solves VMEM chunks of time steps with a log-depth associative_scan over a
// (batch, d_inner block, chunk) grid and carries the state between chunks
// in VMEM scratch along the sequential chunk axis.
//
// What bounds it on the H100: at the served prefill (B=1, T=3000,
// d_inner=8192, d_state=16, bfloat16) the bytes (x, delta and y, 147.5 MB,
// plus B, C and the states, 1.2 MB) take 0.044 ms at 3.35 TB/s, the float32
// arithmetic (393M state updates of about 7 operations) 0.041 ms at 67
// TFLOP/s, and the 393M exponentials 0.094 ms on the special function
// units (16 a clock per SM).  This first kernel gives each (batch, channel,
// state) element its own thread, so that there are B*d_inner*group threads
// to spread over the 132 SMs (131k at the served prefill, where one thread
// per channel would fill 64 blocks): a group of `group` consecutive lanes
// (d_state rounded up to a power of two, at most 32) is one channel, and
// each lane walks time with its h in a float32 register.  Time goes in
// chunks of kUnroll steps: a thread loads the chunk's x, delta, B and C
// together, runs its kUnroll state updates (exp(delta*A) depends on
// nothing but the loads: one FMA per step is on the dependent chain of h),
// then the group sums the chunk's partial y_t (h.C plus D*x_t on the first
// lane) in one reduce-scatter with __shfl_xor_sync: 8 shuffles for 8 steps
// at d_state 16, where a shuffle tree per step would take 32.  The last
// chunk loads delta = 0 past T, which leaves h as it is (the TPU kernel's
// padding rule, here in registers), and stores no y there.  Spare lanes
// (d_state not a power of two) and channels past d_inner run the loop
// with zeros, so every shuffle sees a full warp.
//
// Layout: x, delta and y (B, T, Di) contiguous; A (Di, Ds) and D (Di,)
// float32 contiguous; B and C (B, T, Ds) with unit stride along Ds and the
// given batch and time strides (views of the x_proj split); h0 (optional,
// may be null) and hT (B, Di, Ds) float32 contiguous.  x, delta, B, C and y
// share one dtype, float32 or bfloat16; everything is widened to float32.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/mamba_scan.py.  Each returns cudaGetLastError() after
// its launch, or cudaErrorInvalidValue for a d_state outside [1, 32].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

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
  const void* delta;
  const float* a;
  const void* b;
  const void* c;
  const float* d;
  const float* h0;
  void* y;
  float* h_t;
  int64_t t_len, di_len, ds_len;
  int64_t b_sb, b_st, c_sb, c_st;
};

template <typename T, int kGroup>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(Args args) {
  constexpr int kChannels = kThreads / kGroup;  // channels per block
  const int s = threadIdx.x % kGroup;  // state index of this lane
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * kChannels +
                     threadIdx.x / kGroup;
  const int64_t bi = blockIdx.y;
  const int64_t t_len = args.t_len;
  const int di = static_cast<int>(args.di_len);
  const bool live_ch = ch < di;
  const bool live = live_ch && s < args.ds_len;

  const int64_t state = (bi * di + ch) * args.ds_len + s;
  const float a = live ? args.a[ch * args.ds_len + s] : 0.f;
  // D * x_t enters the sum through the group's first lane
  const float skip = (live_ch && s == 0) ? args.d[ch] : 0.f;
  float h = (live && args.h0) ? args.h0[state] : 0.f;
  const int64_t base = bi * t_len * di + ch;

  for (int64_t t0 = 0; t0 < t_len; t0 += kUnroll) {
    const T* x = static_cast<const T*>(args.x) + base + t0 * di;
    const T* dt = static_cast<const T*>(args.delta) + base + t0 * di;
    const T* bp = static_cast<const T*>(args.b) + bi * args.b_sb + t0 * args.b_st + s;
    const T* cp = static_cast<const T*>(args.c) + bi * args.c_sb + t0 * args.c_st + s;
    // steps past T load zeros: delta = 0 leaves h as it is (exp(0) = 1,
    // nothing injected), the TPU kernel's padding rule, and y is not stored
    float xs[kUnroll], dts[kUnroll], bs[kUnroll], cs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = t0 + u < t_len;
      xs[u] = (live_ch && in) ? to_f32(x[u * di]) : 0.f;
      dts[u] = (live_ch && in) ? to_f32(dt[u * di]) : 0.f;
      bs[u] = (live && in) ? to_f32(bp[u * args.b_st]) : 0.f;
      cs[u] = (live && in) ? to_f32(cp[u * args.c_st]) : 0.f;
    }
    float part[kUnroll];  // this lane's share of y at each step
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float decay = expf(dts[u] * a);
      h = fmaf(decay, h, dts[u] * xs[u] * bs[u]);
      part[u] = fmaf(skip, xs[u], h * cs[u]);
    }
    // Sum each step's partials over the group: a reduce-scatter, where
    // each exchange sends half of the steps a lane still holds, then plain
    // butterflies once a lane holds one.  Lane s ends with the sums of
    // steps first..first+held-1; lanes that differ only in `replica` bits
    // hold the same sums.
    int first = 0, held = kUnroll, replica = 0;
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2) {
      if (held > 1) {
        const bool upper = s & off;
        const int half = held / 2;
#pragma unroll
        for (int i = 0; i < kUnroll / 2; ++i) {
          if (i < half) {
            const float keep = upper ? part[i + half] : part[i];
            const float send = upper ? part[i] : part[i + half];
            part[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        if (upper) first += half;
        held = half;
      } else {
        part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
        replica |= off;
      }
    }
    if (live_ch && (s & replica) == 0) {
      T* y = static_cast<T*>(args.y) + base + t0 * di;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < held && t0 + first + j < t_len) store(y + (first + j) * di, part[j]);
      }
    }
  }
  if (live) args.h_t[state] = h;
}

template <typename T, int kGroup>
int launch_group(const Args& args, int64_t b, void* stream) {
  constexpr int kChannels = kThreads / kGroup;
  const dim3 grid(static_cast<unsigned>((args.di_len + kChannels - 1) / kChannels),
                  static_cast<unsigned>(b));
  mamba_scan_kernel<T, kGroup>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* delta, const void* a, const void* bc,
           const void* cc, const void* d, const void* h0, void* y, void* h_t,
           int64_t b, int64_t t, int64_t di, int64_t ds, int64_t b_sb,
           int64_t b_st, int64_t c_sb, int64_t c_st, void* stream) {
  if (ds < 1 || ds > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || di <= 0) return static_cast<int>(cudaSuccess);
  const Args args{x,  delta, static_cast<const float*>(a), bc, cc,
                  static_cast<const float*>(d), static_cast<const float*>(h0),
                  y,  static_cast<float*>(h_t), t, di, ds, b_sb, b_st, c_sb,
                  c_st};
  if (ds <= 1) return launch_group<T, 1>(args, b, stream);
  if (ds <= 2) return launch_group<T, 2>(args, b, stream);
  if (ds <= 4) return launch_group<T, 4>(args, b, stream);
  if (ds <= 8) return launch_group<T, 8>(args, b, stream);
  if (ds <= 16) return launch_group<T, 16>(args, b, stream);
  return launch_group<T, 32>(args, b, stream);
}

}  // namespace

extern "C" int mamba_scan_f32(const void* x, const void* delta, const void* a,
                              const void* bc, const void* cc, const void* d,
                              const void* h0, void* y, void* h_t, int64_t b,
                              int64_t t, int64_t di, int64_t ds, int64_t b_sb,
                              int64_t b_st, int64_t c_sb, int64_t c_st,
                              void* stream) {
  return launch<float>(x, delta, a, bc, cc, d, h0, y, h_t, b, t, di, ds, b_sb,
                       b_st, c_sb, c_st, stream);
}

extern "C" int mamba_scan_bf16(const void* x, const void* delta, const void* a,
                               const void* bc, const void* cc, const void* d,
                               const void* h0, void* y, void* h_t, int64_t b,
                               int64_t t, int64_t di, int64_t ds, int64_t b_sb,
                               int64_t b_st, int64_t c_sb, int64_t c_st,
                               void* stream) {
  return launch<__nv_bfloat16>(x, delta, a, bc, cc, d, h0, y, h_t, b, t, di,
                               ds, b_sb, b_st, c_sb, c_st, stream);
}
