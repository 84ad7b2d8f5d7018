// Forward flash attention for Hopper (sm_90a): online softmax over kv tiles,
// GQA, causal, sliding window and q_offset masking.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_attn_kernel,
// which walks kv blocks along a sequential grid axis and keeps the running
// max, normaliser and accumulator in VMEM scratch between grid steps.  On
// Hopper blocks run in parallel and share nothing, so the kv loop moves
// inside the block: a block owns (batch, q-head, a tile of query rows) and
// loops over kv tiles, keeping the running max m, the normaliser l and the
// float32 accumulator across the loop.  kv tiles wholly outside
// [q_lo - window + 1, min(q_hi, kv_len - 1)] are never loaded, as on the TPU
// (flash_attention.py:45-53): causal attention costs about half the dense
// loop, windowed attention about window/T of it.
//
// What bounds it on the H100: operations.  RecurrentGemma's prefill layer
// (B=1, Hq=16, Hkv=1, T=S=3000, Dh=256, window 2048) does about 66 GFLOP on
// 52 MB, Granite's (Hq=24, Hkv=8, Dh=64, causal) about 28 GFLOP on 27 MB:
// far above the card's ridge of ~295 operations a byte in bf16, so the
// products belong on the tensor cores.  Two kernels, chosen by the entry
// point the wrapper calls:
//
// * flash_attention_kernel_wgmma: bfloat16 with Dh 64, 128 or 256 (both
//   served widths).  A block of two warpgroups owns 128 query rows, 64 each.
//   Q, K and V reach shared memory by TMA as 64-column (128-byte) boxes in
//   the 128-byte swizzle, through 3-D tensor maps over (Dh, rows, batch x
//   heads): rows past T or S are zero-filled, never read from the next head
//   or batch row.  K and V tiles go through a two-stage ring guarded by
//   mbarriers that count the transaction bytes; one thread issues tile j+1
//   before tile j is computed.  S = Q K^T is one wgmma chain with both
//   operands K-major in shared memory.  P = exp(S - m), rounded to bf16
//   straight from S's accumulator fragment (which is wgmma's A-register
//   layout), multiplies V as the B operand read MN-major through wgmma's
//   transpose bit, so V is never transposed by hand.  S, m, l and O stay in
//   float32 registers.  The element mask runs only on the tiles that
//   straddle a causal, window or S edge.  Unlike the TPU kernel, P enters
//   the second product in bf16.
// * flash_attention_kernel: float32 at any Dh <= 256, and bfloat16 at the
//   other widths.  One block per (batch, head, 64 rows) over 32-row kv
//   tiles, both products on the CUDA cores in float32 (bf16 widened on
//   load), the head zero-padded to 16, 32, 64, 128 or 256.  float32 stays
//   here on purpose: the tensor cores take float32 only as TF32 (a 10-bit
//   mantissa), which would break the full-width float32 model cuts' bars.
//
// Layout: q (B, Hq, T, Dh), k and v (B, Hkv, S, Dh), out (B, Hq, T, Dh),
// all contiguous; query head h reads kv head h / (Hq / Hkv).  Query t sits
// at position t + q_offset and sees key s when s < kv_len, s <= t + q_offset
// (causal) and s > t + q_offset - window (window > 0).  A row that sees no
// key gives 0, as the reference's does.  The wgmma entry also needs q, k, v
// and out 16-byte aligned (TMA's rule); the wrapper checks it.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/flash_attention.py.  Each returns a cudaError_t: that
// of the tensor-map encoding if it failed, else cudaGetLastError() after
// the launch.  The tensor maps are encoded per call through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// CUDA cores: float32, and bfloat16 at widths other than 64, 128 and 256
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// Tensor cores: bfloat16 at Dh 64, 128 and 256 (wgmma fed by TMA)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;    // query rows per warpgroup (wgmma's M)
constexpr int kWgBQ = 128;     // query rows per block: two warpgroups
constexpr int kWgThreads = 256;
constexpr int kBox = 64;       // bf16 columns per 128-byte swizzled box
constexpr int kStages = 2;     // K/V ring depth

template <int DH>
struct WgTile {
  // kv rows per tile: 64 keeps Dh 256's O (128 floats a thread) and Dh 64's
  // two blocks an SM within the register file; Dh 128 takes 128
  static constexpr int BK = DH == 128 ? 128 : 64;
  static constexpr int boxes = DH / kBox;
  static constexpr int q_bytes = kWgBQ * DH * 2;
  static constexpr int kv_bytes = BK * DH * 2;       // one K or one V tile
  static constexpr int stage_bytes = 2 * kv_bytes;
  // 1024 bytes of slack align the swizzle atoms; 8 bytes per mbarrier
  static constexpr size_t smem =
      1024 + q_bytes + kStages * stage_bytes + 8 * (1 + kStages);
  static constexpr int min_blocks = DH == 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// a wait that never completes (a lost TMA load) traps rather than hangs
// the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 3-D tensor map into shared memory; completion is counted in
// bytes on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address and
// leading byte offset in 16-byte units, stride byte offset 1024 (eight
// 128-byte rows, one swizzle atom).  K-major operands ignore the leading
// offset; for MN-major V it is the distance between 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence, commit and wait above
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the special function unit, subnormal results flushed to 0 (a
// softmax weight below 2^-126 is far below what a bf16 output resolves);
// ex2(-inf) = 0, which masked scores rely on
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D(64 x 64, f32) (+)= A(64 x 16) B(16 x 64); A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128, f32) (+)= A(64 x 16) B(16 x 128); A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64, f32) += A(64 x 16, bf16 registers) B(16 x 64); B MN-major
// in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16, bf16 registers) B(16 x 128); B MN-major
// in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 256, f32) += A(64 x 16, bf16 registers) B(16 x 256); B MN-major
// in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Accumulator fragment of a 64 x N wgmma, thread t of its warpgroup: rows
// 16 (t / 32) + (t % 32) / 4 + 8 r, columns 8 i + 2 (t % 4) + c, in
// register 4 i + 2 r + c (r, c in {0, 1}).
template <int DH>
__global__ void __launch_bounds__(kWgThreads, WgTile<DH>::min_blocks)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ out, int hq, int hkv,
                             int t_len, int s_len, int causal, int window,
                             int q_offset, float scale_log2) {
  using W = WgTile<DH>;
  constexpr int BK = W::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + W::q_bytes;  // stage st: K, then V
  const uint32_t q_bar = kv_s + kStages * W::stage_bytes;
  const uint32_t kv_bar = q_bar + 8;       // one per stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // the longest causal rows first, so that the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int kv_head = b * hkv + h / (hq / hkv);
  // this thread's two query rows and its column pair within each 8 columns
  const int row0 = q0 + wg * kWgRows + (tid % 128) / 32 * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);

  // kv rows that any query of the block can see
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + kWgBQ, t_len) - 1 + q_offset;
  int k_first = 0;
  if (window > 0 && q_lo - window + 1 > 0) k_first = q_lo - window + 1;
  int k_last = s_len - 1;
  if (causal && q_hi < k_last) k_last = q_hi;
  const int tile_lo = k_first / BK;
  const int n_tiles = k_last < k_first ? 0 : k_last / BK - tile_lo + 1;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's columns only; summed at the end

  if (n_tiles > 0) {
    auto load_kv = [&](int j) {
      const int st = j % kStages;
      const uint32_t k_dst = kv_s + st * W::stage_bytes;
      const uint32_t bar = kv_bar + 8 * st;
      const int k0 = (tile_lo + j) * BK;
      mbar_expect_tx(bar, W::stage_bytes);
#pragma unroll
      for (int x = 0; x < W::boxes; ++x) {
        tma_load(k_dst + x * BK * 128, &k_map, bar, x * kBox, k0, kv_head);
        tma_load(k_dst + W::kv_bytes + x * BK * 128, &v_map, bar, x * kBox, k0,
                 kv_head);
      }
    };
    if (tid == 0) {
      mbar_init(q_bar, 1);
      for (int st = 0; st < kStages; ++st) mbar_init(kv_bar + 8 * st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(q_bar, W::q_bytes);
#pragma unroll
      for (int x = 0; x < W::boxes; ++x)
        tma_load(q_s + x * kWgBQ * 128, &q_map, q_bar, x * kBox, q0,
                 b * hq + h);
      load_kv(0);
    }
    __syncwarp();
    // this warpgroup's 64 rows of each Q box
    const uint32_t q_wg = q_s + wg * kWgRows * 128;
    const int wq_lo = q0 + wg * kWgRows + q_offset;
    const int wq_hi = wq_lo + kWgRows - 1;
    mbar_wait(q_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      // the stage that tile j+1 overwrites was released by the barrier at
      // the end of iteration j-1
      if (tid == 0 && j + 1 < n_tiles) load_kv(j + 1);
      __syncwarp();
      const int st = j % kStages;
      const uint32_t k_s = kv_s + st * W::stage_bytes;
      const uint32_t v_s = k_s + W::kv_bytes;
      mbar_wait(kv_bar + 8 * st, (j / kStages) & 1);

      // S = Q K^T: 16 columns of Dh per wgmma; inside a 128-byte box the
      // k-th 16 columns start 32 k bytes in (the swizzle is applied by the
      // hardware on the absolute address)
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(s,
                 sw128_desc(q_wg + (kk / 4) * kWgBQ * 128 + off, 16),
                 sw128_desc(k_s + (kk / 4) * BK * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      const int k0 = (tile_lo + j) * BK;
      const bool edge = k0 + BK > s_len || (causal && k0 + BK - 1 > wq_lo) ||
                        (window > 0 && k0 <= wq_hi - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int qpos = row0 + 8 * r + q_offset;
              const int kpos = k0 + 8 * i + col0 + c;
              bool live = kpos < s_len;
              if (causal) live = live && kpos <= qpos;
              if (window > 0) live = live && kpos > qpos - window;
              if (!live) s[4 * i + 2 * r + c] = -INFINITY;
            }
      }

      // online softmax in the log2 domain; the four lanes of a quad share
      // a row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
          mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = fast_exp2(m[r] - m_use);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& e = s[4 * i + 2 * r + c];
            e = fast_exp2(fmaf(e, scale_log2, -m_use));
            sum += e;
          }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          o[4 * i + 2 * r] *= alpha;
          o[4 * i + 2 * r + 1] *= alpha;
        }
      }

      // P as wgmma's A operand: the k-th 16 columns of S are its
      // accumulator registers 8k .. 8k+7, in the A-fragment order
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          p[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

      // O += P V: the k-th 16 kv rows of V start 16 k rows of 128 bytes in
      pin(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, p[kk], sw128_desc(v_s + kk * 16 * 128, BK * 128));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) pin(p[kk]);
      __syncthreads();  // both warpgroups are done with this stage
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum == 0.f ? 0.f : 1.f / sum;
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    __nv_bfloat16* og =
        out + ((static_cast<int64_t>(b) * hq + h) * t_len + row) * DH + col0;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * i) = __floats2bfloat162_rn(
          o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, rows, Dh) bf16, boxes of 64 columns x box_rows rows x 1 head in
// the 128-byte swizzle; out-of-range rows and columns are filled with 0
bool encode_map(CUtensorMap* map, const void* ptr, int64_t heads, int64_t rows,
                int dh, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(rows * dh) * 2};
  const cuuint32_t box[3] = {kBox, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int64_t b, int64_t hq, int64_t hkv, int64_t t_len,
                 int64_t s_len, int causal, int window, int q_offset,
                 float scale, cudaStream_t stream) {
  using W = WgTile<DH>;
  static bool smem_allowed = false;  // as in launch_dh
  if (!smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_wgmma<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(W::smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = true;
  }
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, b * hq, t_len, DH, kWgBQ) ||
      !encode_map(&k_map, k, b * hkv, s_len, DH, W::BK) ||
      !encode_map(&v_map, v, b * hkv, s_len, DH, W::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((t_len + kWgBQ - 1) / kWgBQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  flash_attention_kernel_wgmma<DH><<<grid, kWgThreads, W::smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out),
      static_cast<int>(hq), static_cast<int>(hkv), static_cast<int>(t_len),
      static_cast<int>(s_len), causal, window, q_offset,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16_wgmma(const void* q, const void* k, const void* v, void* out,
                      int64_t b, int64_t hq, int64_t hkv, int64_t t_len,
                      int64_t s_len, int64_t dh, int causal, int64_t window,
                      int64_t q_offset, float scale, void* stream) {
  if (b <= 0 || hq <= 0 || t_len <= 0) return static_cast<int>(cudaSuccess);
  if ((dh != 64 && dh != 128 && dh != 256) || hkv <= 0 || hq % hkv != 0 ||
      s_len < 0 || s_len > INT_MAX / 2 || t_len > INT_MAX / 2 ||
      q_offset > INT_MAX / 2 || q_offset < -(INT_MAX / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_len == 0)  // no key: every row gives 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(b * hq * t_len * dh) * 2, st));
  const int win =
      window <= 0 ? 0 : static_cast<int>(window < INT_MAX / 2 ? window : INT_MAX / 2);
#define FA_WGMMA(DHV)                                                       \
  return launch_wgmma<DHV>(q, k, v, out, b, hq, hkv, t_len, s_len, causal,  \
                           win, static_cast<int>(q_offset), scale, st)
  if (dh == 64) FA_WGMMA(64);
  if (dh == 128) FA_WGMMA(128);
  FA_WGMMA(256);
#undef FA_WGMMA
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

extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k,
                                          const void* v, void* out, int64_t b,
                                          int64_t hq, int64_t hkv,
                                          int64_t t_len, int64_t s_len,
                                          int64_t dh, int causal,
                                          int64_t window, int64_t q_offset,
                                          float scale, void* stream) {
  return launch_bf16_wgmma(q, k, v, out, b, hq, hkv, t_len, s_len, dh, causal,
                           window, q_offset, scale, stream);
}
