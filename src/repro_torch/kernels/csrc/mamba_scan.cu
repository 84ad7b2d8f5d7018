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
// units (16 a clock per SM): the exponentials and the instructions around
// them are the floor, not memory.
//
// Design.  A block takes 32 consecutive channels of one batch row, one per
// lane, and every warp of the block the same 32 channels: warp g holds the
// states [g*G, g*G + G) of its lane's channel in float32 registers, with A
// pre-scaled by log2(e), so that each state update is one ex2.approx (one
// special-function operation), two multiplies and two FMAs, and no lane
// repeats another's work.  A block has kGroups = 4 warps and G is d_state
// / 4 rounded up to a power of two (4 at d_state 16; 2 and 8, with 8 and 2
// warps, were slower).  Time stays serial: (batch, channel, state) already
// gives 131k lanes at the served prefill, and a chunked scan would compute
// every exponential twice.  Time goes in tiles of kTile steps.  The tiles
// of x, delta, B and C come into a ring of kStages shared-memory stages by
// cp.async, two tiles ahead of the one being walked, so the walk never
// waits on device memory: a warp's x and delta rows are 64 (bf16) or 128
// (f32) contiguous bytes copied once, and B_t and C_t, shared by every
// channel, are copied once per block and read as broadcasts.  With only 8
// warps on an SM at the served prefill, a walk that loads, exponentiates
// and updates one step after another waits on latency, so a thread takes
// a sub-tile of steps in two parts: the decays and injections of all its
// steps first (independent of h, so their loads and exponentials overlap),
// then the chain of FMAs through h.  bf16 B and C are widened to float32
// once a tile, in shared memory, not by every thread at every step.  Each
// step's partial y (the thread's states' h.C) goes to shared memory; after
// the tile, warp g sums the warps' partials for its kTile / 4 rows, adds
// D*x_t and stores each row of 32 channels coalesced, in x's dtype.  Rows
// past T are zeros (delta = 0 leaves h as it is).  A decode step (T = 1)
// takes one-row tiles, whose few registers and little shared memory let
// the blocks of all 4 slots run at once.  Where the rows or the B and C
// views are not 16-byte aligned the block loads the tile with plain loads
// instead, the same layout in shared memory.
//
// Layout: x, delta and y (B, T, Di) contiguous; A (Di, Ds) and D (Di,)
// contiguous, each float32 or bfloat16 (a dtype code each: 0 float32, 1
// bfloat16); B and C (B, T, Ds) with unit stride along Ds and the given
// batch and time strides (views of the x_proj split); h0 (optional, may be
// null) and hT (B, Di, Ds) float32 contiguous.  x, delta, B, C and y share
// one dtype, float32 or bfloat16.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/mamba_scan.py.  Each returns cudaGetLastError() after
// its launch, or cudaErrorInvalidValue for a d_state outside [1, 32].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 32;  // channels per block: one per lane
constexpr int kTile = 64;      // time steps per staged tile
constexpr int kSubStates = 32;  // state updates a thread stages together
constexpr int kStages = 3;     // tiles in the cp.async ring
constexpr int kGroups = 4;     // state groups, one warp each
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float load_param(const void* p, int code,
                                            int64_t i) {
  return code ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// 16 bytes global -> shared, asynchronously; bytes past `valid` are zeros
// and are not read
__device__ __forceinline__ void copy16(void* smem, const void* gmem,
                                       int valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// a thread's G consecutive B or C values, one vector load from shared memory
template <int G>
struct alignas(4 * G < 16 ? 4 * G : 16) Pack {
  float v[G];
};

struct Args {
  const void* x;
  const void* delta;
  const void* a;
  const void* b;
  const void* c;
  const void* d;
  const float* h0;
  void* y;
  float* h_t;
  int64_t t_len, di, ds;
  int64_t b_sb, b_st, c_sb, c_st;
  int a_code, d_code;
};

// The shared-memory layout of a block: kStages stages, each the x and delta
// rows of a tile of kLen steps (kTile, or 1 for a decode step), kChannels
// values a row, and its B and C rows (kRowB bytes each: the G * NG states
// padded to 16 bytes); then the partials of one tile, one float per (state
// group, step, channel); then, for bf16, the tile's B and C rows widened to
// float32 (kRowF bytes each), so that the walk reads float32 rows (kRowW
// bytes apart) in either dtype instead of every thread widening them.
template <typename T, int G, int NG, int kLen>
struct Layout {
  static constexpr bool kWiden = sizeof(T) == 2;
  static constexpr int kRowX = kChannels * static_cast<int>(sizeof(T));
  static constexpr int kRowB = (G * NG * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  static constexpr int kStage = 2 * kLen * kRowX + 2 * kLen * kRowB;
  static constexpr int kPart = NG * kLen * kChannels * 4;
  static constexpr int kRowF = G * NG * 4;
  static constexpr int kWide = kWiden ? 2 * kLen * kRowF : 0;
  static constexpr int kRowW = kWiden ? kRowF : kRowB;  // float32 rows walked
};

// Tile [t0, t0 + kLen) of x, delta, B and C into one stage; zeros past T,
// past d_inner and past d_state.
template <typename T, int G, int NG, int kLen, bool kAsync>
__device__ __forceinline__ void stage_tile(const Args& args, char* stage,
                                           int64_t bi, int64_t c0,
                                           int64_t t0) {
  using L = Layout<T, G, NG, kLen>;
  constexpr int kThreads = kChannels * NG;
  const int tid = threadIdx.x;
  const int steps = static_cast<int>(imin(kLen, args.t_len - t0));
  const int live = static_cast<int>(imin(kChannels, args.di - c0));
  const int ds = static_cast<int>(args.ds);
  const T* xg = static_cast<const T*>(args.x);
  const T* dg = static_cast<const T*>(args.delta);
  const T* bg = static_cast<const T*>(args.b) + bi * args.b_sb + t0 * args.b_st;
  const T* cg = static_cast<const T*>(args.c) + bi * args.c_sb + t0 * args.c_st;
  const int64_t row0 = (bi * args.t_len + t0) * args.di + c0;
  char* bs = stage + 2 * kLen * L::kRowX;
  if constexpr (kAsync) {
    constexpr int kChunksX = L::kRowX / 16, kChunksB = L::kRowB / 16;
    for (int i = tid; i < 2 * kLen * kChunksX; i += kThreads) {
      const int arr = i / (kLen * kChunksX), row = (i / kChunksX) % kLen,
                chunk = i % kChunksX;
      const int bytes = live * static_cast<int>(sizeof(T)) - chunk * 16;
      const int valid = row < steps ? max(0, min(16, bytes)) : 0;
      const T* src = (arr ? dg : xg) + row0 + row * args.di;
      copy16(stage + (arr * kLen + row) * L::kRowX + chunk * 16,
             valid ? reinterpret_cast<const char*>(src) + chunk * 16
                   : static_cast<const void*>(xg),
             valid);
    }
    for (int i = tid; i < 2 * kLen * kChunksB; i += kThreads) {
      const int arr = i / (kLen * kChunksB), row = (i / kChunksB) % kLen,
                chunk = i % kChunksB;
      const int bytes = ds * static_cast<int>(sizeof(T)) - chunk * 16;
      const int valid = row < steps ? max(0, min(16, bytes)) : 0;
      const T* src = arr ? cg + row * args.c_st : bg + row * args.b_st;
      copy16(bs + (arr * kLen + row) * L::kRowB + chunk * 16,
             valid ? reinterpret_cast<const char*>(src) + chunk * 16
                   : static_cast<const void*>(xg),
             valid);
    }
  } else {
    constexpr int kRowBe = L::kRowB / static_cast<int>(sizeof(T));
    T* xs = reinterpret_cast<T*>(stage);
    for (int i = tid; i < 2 * kLen * kChannels; i += kThreads) {
      const int arr = i / (kLen * kChannels), row = (i / kChannels) % kLen,
                col = i % kChannels;
      xs[i] = (row < steps && col < live)
                  ? (arr ? dg : xg)[row0 + row * args.di + col]
                  : zero<T>();
    }
    T* b_s = reinterpret_cast<T*>(bs);
    for (int i = tid; i < 2 * kLen * kRowBe; i += kThreads) {
      const int arr = i / (kLen * kRowBe), row = (i / kRowBe) % kLen,
                col = i % kRowBe;
      b_s[i] = (row < steps && col < ds)
                   ? (arr ? cg[row * args.c_st + col] : bg[row * args.b_st + col])
                   : zero<T>();
    }
  }
}

// Walk the first `steps` rows of a staged tile, kSub steps at a time (whole
// sub-tiles: rows past `steps` are zeros and leave h as it is): first every
// step's decays exp2(dt * A log2 e) and injections dt * x * B, which do not
// depend on h, so that their loads and exponentials overlap; then the
// dependent update of h and each step's partial y (h.C over this thread's
// states), stored to this group's row of the partials.  `bc` holds the B
// rows, then the C rows, float32, L::kRowW bytes each.
template <typename T, int G, int NG, int kLen, int kSub>
__device__ __forceinline__ void walk(const char* stage, const char* bc,
                                     float* part, int steps, int lane, int g,
                                     const float (&a2)[G], float (&h)[G]) {
  using L = Layout<T, G, NG, kLen>;
  const T* xs = reinterpret_cast<const T*>(stage);
  const T* dts = reinterpret_cast<const T*>(stage + kLen * L::kRowX);
  const char* bs = bc + g * G * 4;
  const char* cs = bs + kLen * L::kRowW;
  float* mine = part + g * kLen * kChannels + lane;
  for (int u0 = 0; u0 < steps; u0 += kSub) {
    float decay[kSub][G], inject[kSub][G], c[kSub][G];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const int row = u0 + u;
      const float xv = to_f32(xs[row * kChannels + lane]);
      const float dt = to_f32(dts[row * kChannels + lane]);
      const float dtx = dt * xv;
      const Pack<G> bv = *reinterpret_cast<const Pack<G>*>(bs + row * L::kRowW);
      const Pack<G> cv = *reinterpret_cast<const Pack<G>*>(cs + row * L::kRowW);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        decay[u][j] = fast_exp2(dt * a2[j]);
        inject[u][j] = dtx * bv.v[j];
        c[u][j] = cv.v[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        h[j] = fmaf(decay[u][j], h[j], inject[u][j]);
        p = fmaf(h[j], c[u][j], p);
      }
      mine[(u0 + u) * kChannels] = p;
    }
  }
}

template <typename T, int G, int NG, int kLen, bool kAsync>
__global__ void __launch_bounds__(kChannels* NG, kLen == 1 ? 32 / NG : 1)
    mamba_scan_kernel(Args args) {
  using L = Layout<T, G, NG, kLen>;
  constexpr int kSub = kLen == 1 ? 1 : kSubStates / G;
  constexpr int kRows = (kLen + NG - 1) / NG;  // rows each warp stores
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x % kChannels, g = threadIdx.x / kChannels;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChannels;
  const int64_t bi = blockIdx.y;
  const int64_t ch = c0 + lane;
  const bool live_ch = ch < args.di;
  const int64_t t_len = args.t_len;
  const int64_t n_tiles = (t_len + kLen - 1) / kLen;
  const int n_stages = static_cast<int>(imin(kStages, n_tiles));
  float* part = reinterpret_cast<float*>(smem + n_stages * L::kStage);

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      stage_tile<T, G, NG, kLen, kAsync>(args, smem + s * L::kStage, bi, c0,
                                   s * kLen);
    commit();
  }

  float a2[G], h[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int64_t s = g * G + j;
    const bool live = live_ch && s < args.ds;
    const int64_t state = (bi * args.di + ch) * args.ds + s;
    a2[j] = live ? load_param(args.a, args.a_code, ch * args.ds + s) * kLog2e
                 : 0.f;
    h[j] = (live && args.h0) ? args.h0[state] : 0.f;
  }
  const float skip = live_ch ? load_param(args.d, args.d_code, ch) : 0.f;
  T* y = static_cast<T*>(args.y) + bi * t_len * args.di + ch;

  for (int64_t k = 0; k < n_tiles; ++k) {
    wait_pending<kStages - 2>();
    __syncthreads();  // tile k landed; every warp is done with tile k - 1
    const int64_t next = k + kStages - 1;
    if (next < n_tiles)
      stage_tile<T, G, NG, kLen, kAsync>(args, smem + (next % kStages) * L::kStage,
                                   bi, c0, next * kLen);
    commit();
    const char* stage = smem + (k % kStages) * L::kStage;
    const char* bc = stage + 2 * kLen * L::kRowX;
    if constexpr (L::kWiden) {
      constexpr int kStates = G * NG, kRowE = L::kRowB / 2;
      float* wide = part + L::kPart / 4;
      const T* raw = reinterpret_cast<const T*>(bc);
      for (int i = threadIdx.x; i < 2 * kLen * kStates; i += kChannels * NG)
        wide[i] = to_f32(raw[i / kStates * kRowE + i % kStates]);
      __syncthreads();  // the tile's B and C are widened
      bc = reinterpret_cast<const char*>(wide);
    }
    const int steps = static_cast<int>(imin(kLen, t_len - k * kLen));
    walk<T, G, NG, kLen, kSub>(stage, bc, part, steps, lane, g, a2, h);
    __syncthreads();  // every group's partials of the tile are written
    const T* xs = reinterpret_cast<const T*>(stage);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int u = g * kRows + r;
      if (u >= steps) break;
      float acc = skip * to_f32(xs[u * kChannels + lane]);
#pragma unroll
      for (int q = 0; q < NG; ++q) acc += part[(q * kLen + u) * kChannels + lane];
      if (live_ch) store(y + (k * kLen + u) * args.di, acc);
    }
  }
  wait_pending<0>();
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int64_t s = g * G + j;
    if (live_ch && s < args.ds) args.h_t[(bi * args.di + ch) * args.ds + s] = h[j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int G, int NG, int kLen, bool kAsync>
int launch_kernel(const Args& args, int64_t b, void* stream) {
  using L = Layout<T, G, NG, kLen>;
  auto kernel = mamba_scan_kernel<T, G, NG, kLen, kAsync>;
  const int64_t n_tiles = (args.t_len + kLen - 1) / kLen;
  const int smem =
      static_cast<int>(n_tiles < kStages ? n_tiles : kStages) * L::kStage +
      L::kPart + L::kWide;
  // above 48 KB a kernel must opt in, once per device
  static int allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > allowed[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = smem;
  }
  const dim3 grid(static_cast<unsigned>((args.di + kChannels - 1) / kChannels),
                  static_cast<unsigned>(b));
  kernel<<<grid, kChannels * NG, smem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int NG>
int launch_shape(const Args& args, int64_t b, void* stream) {
  constexpr int elem = static_cast<int>(sizeof(T));
  // cp.async moves 16-byte chunks: every row of x, delta, B and C must
  // start on 16 bytes (B's and C's batch stride matters only when B > 1)
  const bool async =
      aligned16(args.x) && aligned16(args.delta) && aligned16(args.b) &&
      aligned16(args.c) && (args.di * elem) % 16 == 0 &&
      (args.b_st * elem) % 16 == 0 && (args.c_st * elem) % 16 == 0 &&
      (b == 1 || ((args.b_sb * elem) % 16 == 0 && (args.c_sb * elem) % 16 == 0));
  // a decode step stages and walks one row, in a block with few registers
  // and little shared memory, so that the blocks of all slots run at once
  if (async && args.t_len == 1)
    return launch_kernel<T, G, NG, 1, true>(args, b, stream);
  return async ? launch_kernel<T, G, NG, kTile, true>(args, b, stream)
               : launch_kernel<T, G, NG, kTile, false>(args, b, stream);
}

template <typename T>
int launch(const void* x, const void* delta, const void* a, const void* bc,
           const void* cc, const void* d, const void* h0, void* y, void* h_t,
           int64_t b, int64_t t, int64_t di, int64_t ds, int64_t b_sb,
           int64_t b_st, int64_t c_sb, int64_t c_st, int64_t a_code,
           int64_t d_code, void* stream) {
  if (ds < 1 || ds > 32 || ds > 8 * kGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || di <= 0 || t <= 0) return static_cast<int>(cudaSuccess);
  const Args args{x,    delta, a,    bc,   cc,   d,
                  static_cast<const float*>(h0),
                  y,    static_cast<float*>(h_t),
                  t,    di,    ds,   b_sb, b_st, c_sb, c_st,
                  static_cast<int>(a_code), static_cast<int>(d_code)};
  // kGroups warps, each thread the next power of two >= ds / kGroups states
  if (ds <= kGroups) return launch_shape<T, 1, kGroups>(args, b, stream);
  if (ds <= 2 * kGroups) return launch_shape<T, 2, kGroups>(args, b, stream);
  if (ds <= 4 * kGroups) return launch_shape<T, 4, kGroups>(args, b, stream);
  return launch_shape<T, 8, kGroups>(args, b, stream);
}

}  // namespace

extern "C" int mamba_scan_f32(const void* x, const void* delta, const void* a,
                              const void* bc, const void* cc, const void* d,
                              const void* h0, void* y, void* h_t, int64_t b,
                              int64_t t, int64_t di, int64_t ds, int64_t b_sb,
                              int64_t b_st, int64_t c_sb, int64_t c_st,
                              int64_t a_code, int64_t d_code, void* stream) {
  return launch<float>(x, delta, a, bc, cc, d, h0, y, h_t, b, t, di, ds, b_sb,
                       b_st, c_sb, c_st, a_code, d_code, stream);
}

extern "C" int mamba_scan_bf16(const void* x, const void* delta, const void* a,
                               const void* bc, const void* cc, const void* d,
                               const void* h0, void* y, void* h_t, int64_t b,
                               int64_t t, int64_t di, int64_t ds, int64_t b_sb,
                               int64_t b_st, int64_t c_sb, int64_t c_st,
                               int64_t a_code, int64_t d_code, void* stream) {
  return launch<__nv_bfloat16>(x, delta, a, bc, cc, d, h0, y, h_t, b, t, di,
                               ds, b_sb, b_st, c_sb, c_st, a_code, d_code,
                               stream);
}
