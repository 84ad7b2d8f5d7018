// Forward flash attention for Hopper (sm_90a): online softmax over kv tiles,
// GQA, causal, sliding window and q_offset masking.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_attn_kernel,
// which walks kv blocks along a sequential grid axis and keeps the running
// max, normaliser and accumulator in VMEM scratch between grid steps.  On
// Hopper blocks run in parallel and share nothing, so the kv loop moves
// inside the block: one block owns (batch, q-head, 64 query rows) and loops
// over 32-row kv tiles, keeping the running max m, the normaliser l (both
// in shared memory) and the (64 x Dh) float32 accumulator (in registers,
// 4 rows x Dh/16 columns per thread) across the loop.
//
// What bounds it on the H100: operations.  At the served prefill (B=1,
// Hq=16, Hkv=1, T=S=3000, Dh=256, window 2048) a layer does about 66 GFLOP
// on about 52 MB, far above the card's ridge.  This first kernel runs the
// two products on the CUDA cores in float32 (every input is widened on
// load), so it sits well above its tensor-core bound; `mma.sync`/`wgmma`
// with TMA-fed tiles is the work of a later PR.  What the design does keep
// from the TPU kernel is the arithmetic it skips: kv tiles wholly outside
// [q_lo - window + 1, min(q_hi, kv_len - 1)] are never loaded, so causal
// attention costs about half the dense loop and windowed attention about
// window/T of it.
//
// Layout: q (B, Hq, T, Dh), k and v (B, Hkv, S, Dh), out (B, Hq, T, Dh),
// all contiguous, in float32 or bfloat16; query head h reads kv head
// h / (Hq / Hkv).  Query t sits at position t + q_offset and sees key s
// when s < kv_len, s <= t + q_offset (causal) and s > t + q_offset - window
// (window > 0).  A row that sees no key gives 0, as the reference's does.
// Dh <= 256: the kernel is instantiated for head widths 16, 32, 64, 128
// and 256 and zero-pads Dh up to the next of them.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/flash_attention.py.  Each returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // kv rows per tile (one per lane in softmax)
constexpr int kThreads = 256; // 16 x 16 threads: ty owns 4 rows, tx columns

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row pad of 4 bytes keeps the strided shared-memory reads of neighbouring
// row groups on different banks.
template <typename T>
struct Pad { static constexpr int v = 4 / static_cast<int>(sizeof(T)); };

template <typename T, int DH>
struct Smem {
  static constexpr int q_ld = DH + Pad<T>::v;   // Qs[r][d]
  static constexpr int kt_ld = kBK + Pad<T>::v; // Kt[d][c], K transposed
  static constexpr int p_ld = kBK + 1;          // Ps[r][c], float32
  static constexpr size_t f32_words = 3 * kBQ + kBQ * p_ld;  // m, l, alpha, P
  static constexpr size_t bytes =
      f32_words * 4 + sizeof(T) * (kBQ * q_ld + DH * kt_ld + kBK * DH);
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int64_t t_len, int64_t s_len, int dh,
                       int causal, int64_t window, int64_t q_offset,
                       float scale) {
  using S = Smem<T, DH>;
  constexpr int kCols = DH / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_s = reinterpret_cast<float*>(smem_raw);
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  float* p_s = a_s + kBQ;
  T* q_s = reinterpret_cast<T*>(p_s + kBQ * S::p_ld);
  T* kt_s = q_s + kBQ * S::q_ld;
  T* v_s = kt_s + DH * S::kt_ld;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int64_t kvh = h / (hq / hkv);
  const T* qg = q + ((b * hq + h) * t_len) * dh;
  const T* kg = k + ((b * hkv + kvh) * s_len) * dh;
  const T* vg = v + ((b * hkv + kvh) * s_len) * dh;
  T* og = out + ((b * hq + h) * t_len) * dh;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    q_s[r * S::q_ld + d] =
        (q0 + r < t_len && d < dh) ? qg[(q0 + r) * dh + d] : zero<T>();
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // kv rows that any query of this tile can see; whole tiles outside are
  // skipped, as the TPU kernel skips them (flash_attention.py:45-53)
  const int64_t q_lo = q0 + q_offset;
  const int64_t q_hi = q_lo + kBQ - 1;
  int64_t k_first = 0;
  if (window > 0 && q_lo - window + 1 > 0) k_first = q_lo - window + 1;
  int64_t k_last = s_len - 1;
  if (causal && q_hi < k_last) k_last = q_hi;
  const int64_t tile_lo = k_first / kBK;
  const int64_t tile_hi = k_last < k_first ? tile_lo - 1 : k_last / kBK;

  for (int64_t tile = tile_lo; tile <= tile_hi; ++tile) {
    const int64_t k0 = tile * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      const bool in = k0 + c < s_len && d < dh;
      kt_s[d * S::kt_ld + c] = in ? kg[(k0 + c) * dh + d] : zero<T>();
      v_s[c * DH + d] = in ? vg[(k0 + c) * dh + d] : zero<T>();
    }
    __syncthreads();

    // scores: rows ty*4+i, columns tx and tx+16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float k_a = to_f32(kt_s[d * S::kt_ld + tx]);
      const float k_b = to_f32(kt_s[d * S::kt_ld + tx + 16]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = to_f32(q_s[(ty * 4 + i) * S::q_ld + d]);
        s[i][0] = fmaf(qv, k_a, s[i][0]);
        s[i][1] = fmaf(qv, k_b, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int64_t qpos = q0 + r + q_offset;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = tx + 16 * jj;
        const int64_t kpos = k0 + c;
        bool live = kpos < s_len;
        if (causal) live = live && kpos <= qpos;
        if (window > 0) live = live && kpos > qpos - window;
        p_s[r * S::p_ld + c] = live ? s[i][jj] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w+7, lane = kv column
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float sv = p_s[r * S::p_ld + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
      const float p = sv == -INFINITY ? 0.f : expf(sv - m_safe);
      const float psum = warp_sum(p);
      p_s[r * S::p_ld + lane] = p;
      __syncwarp();
      if (lane == 0) {
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty*4+i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty * 4 + i) * S::p_ld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = to_f32(v_s[c * DH + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= t_len) continue;
    const float l = l_s[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) store(og + (q0 + r) * dh + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int DH>
int launch_dh(const T* q, const T* k, const T* v, T* out, int64_t b,
              int64_t hq, int64_t hkv, int64_t t_len, int64_t s_len,
              int64_t dh, int causal, int64_t window, int64_t q_offset,
              float scale, cudaStream_t stream) {
  const size_t smem = Smem<T, DH>::bytes;
  // above 48 KB a block's shared memory must be allowed first, once per
  // instantiation (a repeated store of the same true is a benign race)
  static bool smem_allowed = false;
  if (!smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = true;
  }
  const dim3 grid(static_cast<unsigned>((t_len + kBQ - 1) / kBQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, static_cast<int>(hq), static_cast<int>(hkv), t_len, s_len,
      static_cast<int>(dh), causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int64_t b,
           int64_t hq, int64_t hkv, int64_t t_len, int64_t s_len, int64_t dh,
           int causal, int64_t window, int64_t q_offset, float scale,
           void* stream) {
  if (b <= 0 || hq <= 0 || t_len <= 0 || dh <= 0)
    return static_cast<int>(cudaSuccess);
  if (dh > 256 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(DHV)                                                      \
  return launch_dh<T, DHV>(qp, kp, vp, op, b, hq, hkv, t_len, s_len, dh,    \
                           causal, window, q_offset, scale, st)
  if (dh <= 16) FA_LAUNCH(16);
  if (dh <= 32) FA_LAUNCH(32);
  if (dh <= 64) FA_LAUNCH(64);
  if (dh <= 128) FA_LAUNCH(128);
  FA_LAUNCH(256);
#undef FA_LAUNCH
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int64_t b, int64_t hq,
                                   int64_t hkv, int64_t t_len, int64_t s_len,
                                   int64_t dh, int causal, int64_t window,
                                   int64_t q_offset, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, out, b, hq, hkv, t_len, s_len, dh, causal,
                       window, q_offset, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int64_t b,
                                    int64_t hq, int64_t hkv, int64_t t_len,
                                    int64_t s_len, int64_t dh, int causal,
                                    int64_t window, int64_t q_offset,
                                    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, t_len, s_len, dh,
                               causal, window, q_offset, scale, stream);
}
