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
// float32, and the result is in the tokens' dtype.
//
// What bounds it on the H100: bytes.  The kept (T, D) rows in and the
// (E, C, D) buffers out are the whole of the traffic (151 MB at Granite's
// prefill in bfloat16).  The first version of this kernel added every
// kept row into a zero-filled float32 (E, C, D) buffer with float32
// atomics and cast it back: three to four times those bytes.  This one is
// output-stationary and writes every output byte once, in the tokens'
// dtype:
//
// 1. Index pass, one thread per row: for each kept row t, atomicMax of
//    T - t (the first row of the pair, as the largest T - t) and
//    atomicAdd of 1 into two int32 tables of E * C entries, zero-filled
//    on the stream first.
// 2. Gather pass, one warp per output row (e, c), 16-byte loads and stores
//    where D and the pointers allow: zeros where the pair's count is 0; a
//    straight copy of its first row where the count is 1, bit for bit; and
//    where the count is above 1, the float32 sum of the pair's rows in row
//    order, cast once.  Repeated pairs are rare (the clamp to C-1), so the
//    warp finds a pair's rows by scanning the ids from the pair's first
//    row on, 32 rows a step, in row order, until it has found them all;
//    it scans again for each column tile, which keeps its registers to
//    one vector a lane.  A counting sort would bound the scan where a
//    pair's rows lie far apart, at the price of a third pass on every
//    call.
//
// A small dispatch (the decode step's 32 rows into (40, 8, D)) is bound
// by the host's cost of a call, not by bytes: there both passes run in one
// launch, each block building the index in shared memory, with no tables
// in device memory and no memset.  The caller chooses it by passing no
// tables (repro_torch/kernels/moe_dispatch.py holds the size limits); its
// 2 * E * C int32 of shared memory must fit a launch's 48 KB, or the
// launch fails and the entry returns the error.
//
// Row-order float32 sums equal the plain version on the CPU (whose
// index_add_ adds repeated rows in row order) bit for bit, and do not
// change from run to run.
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/moe_dispatch.py.  `out` is the (E, C, D) result in
// the tokens' dtype and `tables` an int32 workspace of 2 * E * C entries,
// or null for a small dispatch; both are the caller's, and the entry
// writes every byte of `out`.  Each entry zero-fills the tables, launches
// both passes on the given stream (the index pass only where T > 0), or
// the one-launch path where `tables` is null, and returns the first CUDA
// error (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps a block
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ bool kept(int32_t ex, int32_t sl, int64_t e,
                                     int64_t c) {
  return ex >= 0 && static_cast<int64_t>(ex) < e && sl >= 0 &&
         static_cast<int64_t>(sl) < c;
}

// tables[0, E*C): T - (first row of the pair), 0 where no row;
// tables[E*C, 2*E*C): the pair's count of rows
__global__ void __launch_bounds__(kThreads)
moe_dispatch_index_kernel(const int32_t* __restrict__ expert_ids,
                          const int32_t* __restrict__ slot_ids,
                          int32_t* __restrict__ tables, int64_t t, int64_t e,
                          int64_t c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < t; row += stride) {
    const int32_t ex = __ldg(expert_ids + row);
    const int32_t sl = __ldg(slot_ids + row);
    if (!kept(ex, sl, e, c)) continue;
    const int64_t pair = static_cast<int64_t>(ex) * c + sl;
    atomicMax(tables + pair, static_cast<int32_t>(t - row));
    atomicAdd(tables + e * c + pair, 1);
  }
}

template <typename T>
struct Vec;  // VEC elements of T moved as one 16-byte word, or one element

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Word = float4;
  __device__ static void widen(const Word& w, float (&f)[kN]) {
    f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
  }
  __device__ static Word narrow(const float (&f)[kN]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Word = uint4;
  __device__ static void widen(const Word& w, float (&f)[kN]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      const float2 x = __bfloat1622float2(p[j]);
      f[2 * j] = x.x;
      f[2 * j + 1] = x.y;
    }
  }
  __device__ static Word narrow(const float (&f)[kN]) {
    Word w;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int j = 0; j < kN / 2; ++j)
      p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return w;
  }
};

// one element moved on its own: the path for a D or a base that 16-byte
// words do not fit
template <typename T>
struct Scalar {
  static constexpr int kN = 1;
  using Word = T;
  __device__ static void widen(const Word& w, float (&f)[kN]) {
    f[0] = static_cast<float>(w);
  }
  __device__ static Word narrow(const float (&f)[kN]) { return Word(f[0]); }
};

template <>
struct Scalar<__nv_bfloat16> {
  static constexpr int kN = 1;
  using Word = __nv_bfloat16;
  __device__ static void widen(const Word& w, float (&f)[kN]) {
    f[0] = __bfloat162float(w);
  }
  __device__ static Word narrow(const float (&f)[kN]) {
    return __float2bfloat16_rn(f[0]);
  }
};

// One warp writes output row `pair` = (e, c), D / V::kN words of V::Word
// (`tokens` and `out` are read and written as words: D is a multiple of
// V::kN), from the pair's count of rows and T - its first row.
template <typename T, typename V>
__device__ __forceinline__ void write_pair(
    const T* __restrict__ tokens, const int32_t* __restrict__ expert_ids,
    const int32_t* __restrict__ slot_ids, T* __restrict__ out, int64_t t,
    int64_t d, int64_t c, int64_t pair, int32_t count, int32_t first_inv,
    int lane) {
  using Word = typename V::Word;
  const int64_t words = d / V::kN;
  Word* dst = reinterpret_cast<Word*>(out + pair * d);
  if (count == 0) {
    float zero[V::kN] = {};
    const Word z = V::narrow(zero);
#pragma unroll 4
    for (int64_t w = lane; w < words; w += 32) dst[w] = z;
    return;
  }
  const int64_t first = t - first_inv;
  if (count == 1) {
    const Word* src = reinterpret_cast<const Word*>(tokens + first * d);
#pragma unroll 4
    for (int64_t w = lane; w < words; w += 32) dst[w] = __ldg(src + w);
    return;
  }
  // count > 1: the pair's rows in row order, scanned from `first` for each
  // tile of 32 words
  const int32_t ex = static_cast<int32_t>(pair / c);
  const int32_t sl = static_cast<int32_t>(pair - static_cast<int64_t>(ex) * c);
  for (int64_t w0 = 0; w0 < words; w0 += 32) {
    const int64_t w = w0 + lane;
    float acc[V::kN] = {};
    int found = 0;
    for (int64_t r0 = first; found < count && r0 < t; r0 += 32) {
      const int64_t r = r0 + lane;
      const bool match = r < t && __ldg(expert_ids + r) == ex &&
                         __ldg(slot_ids + r) == sl;
      unsigned hits = __ballot_sync(kFull, match);
      while (hits) {  // in lane order, which is row order
        const int src_lane = __ffs(hits) - 1;
        hits &= hits - 1;
        const int64_t row = r0 + src_lane;
        if (w < words) {
          float f[V::kN];
          V::widen(__ldg(reinterpret_cast<const Word*>(tokens + row * d) + w),
                   f);
#pragma unroll
          for (int j = 0; j < V::kN; ++j) acc[j] += f[j];
        }
        ++found;
      }
    }
    if (w < words) dst[w] = V::narrow(acc);
  }
}

// The gather pass over the index pass's tables in device memory: warp w
// writes output rows w, w + warps, ...
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
moe_dispatch_gather_kernel(const T* __restrict__ tokens,
                           const int32_t* __restrict__ expert_ids,
                           const int32_t* __restrict__ slot_ids,
                           const int32_t* __restrict__ tables,
                           T* __restrict__ out, int64_t t, int64_t d,
                           int64_t e, int64_t c) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t pair = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
       pair < e * c; pair += warps) {
    write_pair<T, V>(tokens, expert_ids, slot_ids, out, t, d, c, pair,
                     __ldg(tables + e * c + pair), __ldg(tables + pair), lane);
  }
}

// Both passes in one launch, for a small dispatch (the decode step's):
// each block builds the whole index in shared memory (its tables zeroed
// there, every row indexed again by every block, which costs little at
// few rows), then gathers its own output rows.  No device-memory tables,
// no memset, one launch instead of three.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
moe_dispatch_small_kernel(const T* __restrict__ tokens,
                          const int32_t* __restrict__ expert_ids,
                          const int32_t* __restrict__ slot_ids,
                          T* __restrict__ out, int64_t t, int64_t d,
                          int64_t e, int64_t c) {
  extern __shared__ int32_t shared_tables[];  // T - first row, then counts
  const int64_t pairs = e * c;
  for (int64_t i = threadIdx.x; i < 2 * pairs; i += blockDim.x)
    shared_tables[i] = 0;
  __syncthreads();
  for (int64_t row = threadIdx.x; row < t; row += blockDim.x) {
    const int32_t ex = __ldg(expert_ids + row);
    const int32_t sl = __ldg(slot_ids + row);
    if (!kept(ex, sl, e, c)) continue;
    const int64_t pair = static_cast<int64_t>(ex) * c + sl;
    atomicMax(shared_tables + pair, static_cast<int32_t>(t - row));
    atomicAdd(shared_tables + pairs + pair, 1);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t pair = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
       pair < pairs; pair += warps) {
    write_pair<T, V>(tokens, expert_ids, slot_ids, out, t, d, c, pair,
                     shared_tables[pairs + pair], shared_tables[pair], lane);
  }
}

template <typename T, typename V>
int launch_passes(const T* tokens, const int32_t* expert_ids,
                  const int32_t* slot_ids, int32_t* tables, T* out, int64_t t,
                  int64_t d, int64_t e, int64_t c, cudaStream_t stream) {
  const int64_t warps_per_block = kThreads / 32;
  int64_t blocks = (e * c + warps_per_block - 1) / warps_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (tables == nullptr) {
    moe_dispatch_small_kernel<T, V>
        <<<static_cast<unsigned>(blocks), kThreads,
           static_cast<size_t>(2 * e * c) * sizeof(int32_t), stream>>>(
            tokens, expert_ids, slot_ids, out, t, d, e, c);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaMemsetAsync(
      tables, 0, static_cast<size_t>(2 * e * c) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t > 0) {
    int64_t index_blocks = (t + kThreads - 1) / kThreads;
    if (index_blocks > kMaxBlocks) index_blocks = kMaxBlocks;
    moe_dispatch_index_kernel<<<static_cast<unsigned>(index_blocks), kThreads,
                                0, stream>>>(expert_ids, slot_ids, tables, t,
                                             e, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moe_dispatch_gather_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads,
                                     0, stream>>>(tokens, expert_ids, slot_ids,
                                                  tables, out, t, d, e, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* tokens, const int32_t* expert_ids, const int32_t* slot_ids,
           T* out, int32_t* tables, int64_t t, int64_t d, int64_t e, int64_t c,
           cudaStream_t stream) {
  if (d <= 0 || e <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  // 16-byte words need every row start of tokens and out on a 16-byte
  // boundary
  constexpr int kWord = 16 / static_cast<int>(sizeof(T));
  const bool words = d % kWord == 0 &&
                     reinterpret_cast<uintptr_t>(tokens) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (words)
    return launch_passes<T, Vec<T>>(tokens, expert_ids, slot_ids, tables, out,
                                    t, d, e, c, stream);
  return launch_passes<T, Scalar<T>>(tokens, expert_ids, slot_ids, tables, out,
                                     t, d, e, c, stream);
}

}  // namespace

extern "C" int moe_dispatch_f32(const void* tokens, const void* expert_ids,
                                const void* slot_ids, void* out, void* tables,
                                int64_t t, int64_t d, int64_t e, int64_t c,
                                void* stream) {
  return launch(static_cast<const float*>(tokens),
                static_cast<const int32_t*>(expert_ids),
                static_cast<const int32_t*>(slot_ids), static_cast<float*>(out),
                static_cast<int32_t*>(tables), t, d, e, c,
                static_cast<cudaStream_t>(stream));
}

extern "C" int moe_dispatch_bf16(const void* tokens, const void* expert_ids,
                                 const void* slot_ids, void* out, void* tables,
                                 int64_t t, int64_t d, int64_t e, int64_t c,
                                 void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(tokens),
                static_cast<const int32_t*>(expert_ids),
                static_cast<const int32_t*>(slot_ids),
                static_cast<__nv_bfloat16*>(out),
                static_cast<int32_t*>(tables), t, d, e, c,
                static_cast<cudaStream_t>(stream));
}
