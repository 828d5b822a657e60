// group_norm_silu: GroupNorm (fp32 single-pass moments) then SiLU on a
// channels_last map -- logically [B, C, H, W], in memory [B, H*W, C], the
// TPU kernel's own layout -- in bf16 or fp32, as two launches with nothing
// between them:
//
//   group_norm_stats: grid (slabs, B). Block (s, b) sums rows
//                     [s*rows, (s+1)*rows) of image b per channel, sum(x)
//                     and sum(x^2) in fp32, and writes its own partial pair
//                     -> partial [B, slabs, 2, C];
//   group_norm_apply: the same grid. Block (s, b) first folds image b's
//                     partials into shared memory (the epilogue: per-channel
//                     sums over the slabs, per-group sums over the group's
//                     channels, mean, var = max(E[x^2] - mean^2, 0),
//                     rsqrt(var + eps), mul = inv * scale, add = bias - mean
//                     * mul), then writes y = silu(x * mul + add) over the
//                     same rows, computed in fp32 and rounded once to x's
//                     dtype. It walks the rows backward, so the ones the
//                     stats block read last, still in L2, come first.
//
// Replaces the TPU kernels
// deepl_project_tpu/ops/pallas/fused_norm.py::_stats_kernel and
// ::_apply_kernel (group_norm_silu) and the XLA epilogue between them. The
// TPU runs its grid in order and adds each row block's per-channel sums
// into one revisited [2, C] block; CUDA blocks run in parallel in no order,
// so every stats block writes its own partials (no atomics) and every sum
// after them runs in a fixed index order: the result does not depend on the
// order the blocks ran in, and every apply block folds an image to the same
// bits.
//
// Layout: a thread owns one 8-channel vector position (C/8 per row) and
// keeps it over every row it visits: a block of (C/8) * k threads covers k
// consecutive rows, k*C contiguous values, per step, 16 bytes a thread. An
// 8-wide vector may cross a group boundary (C=192 has groups of 6), so the
// kernel never groups in registers: it keeps per-channel sums, as the TPU
// kernel does, and groups in the fold.
//
// Bound on an H100: memory. At large f16d32 256px stage 0 (32 images,
// C=192, 256x256, bf16) x is 805 MB: the stats kernel reads it once (0.240
// ms at 3.35 TB/s), the apply kernel reads it once and writes y once (0.481
// ms). Both grids are about one resident wave (4 blocks of <= 256 threads
// an SM). The fold costs each apply block slabs * 2C fp32 reads from L2;
// the wrapper keeps slabs^2 <= H*W / 40, a few percent of a block's bytes.
// SiLU uses the fast exp and divide (2 MUFU operations a value): with
// expf and an IEEE divide the apply kernel issued ~25 instructions a value,
// near the SM's issue rate at 3.35 TB/s of bf16.
//
// Requires C % 8 == 0, C <= 2048 and x and y 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

constexpr int kMaxThreads = 256;
constexpr int kMaxC = 2048;  // (C/8) * k <= 256 threads cover a row
constexpr int kVec = 8;      // channels per thread per load
constexpr int kUnroll = 4;   // rows in flight per thread

// 8 values of T as they sit in registers between a 16-byte-wide load and
// their use: one uint4 of bf16, two float4 of fp32.
template <typename T>
struct Raw;

template <>
struct Raw<__nv_bfloat16> {
  uint4 d;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    d = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack(float v[kVec]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  // Round once to bf16 and store, evict-first: nothing reads y again soon
  // enough to find it in L2.
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float v[kVec]) {
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), o);
  }
};

template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void unpack(float v[kVec]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float v[kVec]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
};

// Grid (slabs, B), block (C/8) * k threads. Block (s, b) walks rows
// [s*rows, (s+1)*rows) of image b forward, k rows a step; partial
// [B, slabs, 2, C].
template <typename T>
__global__ __launch_bounds__(kMaxThreads, 4) void stats_kernel(
    const T* __restrict__ x, float* __restrict__ partial, int hw, int c,
    int rows_per_slab) {
  const int nvec = c / kVec, k = blockDim.x / nvec;
  const int t = threadIdx.x, vpos = t % nvec, r = t / nvec;
  const int b = blockIdx.y, s = blockIdx.x;
  const int row1 = min((s + 1) * rows_per_slab, hw);
  const size_t step = (size_t)k * c;
  int row = s * rows_per_slab + r;
  const T* p = x + ((size_t)b * hw + row) * c + (size_t)vpos * kVec;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
  for (; row + (kUnroll - 1) * k < row1; row += kUnroll * k, p += kUnroll * step) {
    Raw<T> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u].load(p + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kVec];
      raw[u].unpack(v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
  }
  for (; row < row1; row += k, p += step) {
    Raw<T> raw;
    raw.load(p);
    float v[kVec];
    raw.unpack(v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1[j] += v[j];
      s2[j] += v[j] * v[j];
    }
  }
  // The k threads of one vector position: summed in row-group order.
  __shared__ float red[2][kMaxThreads * kVec];  // [moment][k * C]
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    red[0][r * c + vpos * kVec + j] = s1[j];
    red[1][r * c + vpos * kVec + j] = s2[j];
  }
  __syncthreads();
  float* out = partial + ((size_t)b * gridDim.x + s) * 2 * c;
  for (int ch = t; ch < c; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < k; ++i) {
      a += red[0][i * c + ch];
      q += red[1][i * c + ch];
    }
    out[ch] = a;
    out[c + ch] = q;
  }
}

template <bool kSilu>
__device__ __forceinline__ float act(float z) {
  // silu(z) = z * sigmoid(z); __expf(-z) overflows to inf for z < -88,
  // and z / inf is -0, silu's limit.
  return kSilu ? __fdividef(z, 1.f + __expf(-z)) : z;
}

// Grid (slabs, B) as the stats kernel's, block (C/8) * k threads. Block
// (s, b) folds image b's partials (the `slabs` pairs) into mul/add in
// shared memory, then walks its rows backward: the stats kernel's blocks
// walked them forward, so the rows it read last -- the ones still in L2 --
// come first.
template <typename T, bool kSilu>
__global__ __launch_bounds__(kMaxThreads, 4) void apply_kernel(
    const T* __restrict__ x, const float* __restrict__ partial, int slabs,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ y, int hw, int c, int groups, int rows_per_slab, float eps) {
  __shared__ float sums[2][kMaxC];
  __shared__ float coef[2][kMaxC];  // mul, add
  const int nvec = c / kVec, k = blockDim.x / nvec;
  const int t = threadIdx.x, vpos = t % nvec, r = t / nvec;
  const int b = blockIdx.y, s = blockIdx.x;
  // Fold: per-channel sums over the slabs, in slab order.
  const float* p = partial + (size_t)b * slabs * 2 * c;
  for (int ch = t; ch < c; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
#pragma unroll 8
    for (int i = 0; i < slabs; ++i) {
      a += __ldg(p + (size_t)i * 2 * c + ch);
      q += __ldg(p + (size_t)i * 2 * c + c + ch);
    }
    sums[0][ch] = a;
    sums[1][ch] = q;
  }
  __syncthreads();
  // Per-group moments over the group's channels, in channel order.
  const int cg = c / groups;
  const float count = (float)((long long)hw * cg);
  for (int ch = t; ch < c; ch += blockDim.x) {
    const int g0 = (ch / cg) * cg;
    float a = 0.f, q = 0.f;
    for (int i = 0; i < cg; ++i) {
      a += sums[0][g0 + i];
      q += sums[1][g0 + i];
    }
    const float mean = a / count;
    const float var = fmaxf(q / count - mean * mean, 0.f);
    const float m = rsqrtf(var + eps) * scale[ch];
    coef[0][ch] = m;
    coef[1][ch] = bias[ch] - mean * m;
  }
  __syncthreads();
  float m[kVec], a[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    m[j] = coef[0][vpos * kVec + j];
    a[j] = coef[1][vpos * kVec + j];
  }
  const int row0 = s * rows_per_slab + r, row1 = min((s + 1) * rows_per_slab, hw);
  if (row0 >= row1) return;
  // This thread's rows are row0, row0 + k, ...: start from the last.
  int row = row0 + (row1 - 1 - row0) / k * k;
  const size_t step = (size_t)k * c;
  const size_t off = ((size_t)b * hw + row) * c + (size_t)vpos * kVec;
  const T* xp = x + off;
  T* yp = y + off;
  for (; row - (kUnroll - 1) * k >= row0; row -= kUnroll * k, xp -= kUnroll * step,
                                         yp -= kUnroll * step) {
    Raw<T> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u].load(xp - u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kVec];
      raw[u].unpack(v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = act<kSilu>(v[j] * m[j] + a[j]);
      Raw<T>::store(yp - u * step, v);
    }
  }
  for (; row >= row0; row -= k, xp -= step, yp -= step) {
    Raw<T> raw;
    raw.load(xp);
    float v[kVec];
    raw.unpack(v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = act<kSilu>(v[j] * m[j] + a[j]);
    Raw<T>::store(yp, v);
  }
}

// (C/8) * k threads, k = the rows one step covers.
static int block_threads(int c) {
  const int nvec = c / kVec;
  return nvec * (nvec >= kMaxThreads ? 1 : kMaxThreads / nvec);
}

template <typename T>
static void launch_apply(const void* x, const void* partial, int slabs, const void* scale,
                         const void* bias, void* y, int batch, int hw, int c, int groups,
                         int rows_per_slab, float eps, int silu, cudaStream_t stream) {
  dim3 grid((hw + rows_per_slab - 1) / rows_per_slab, batch);
  const int threads = block_threads(c);
  auto kernel = silu ? apply_kernel<T, true> : apply_kernel<T, false>;
  kernel<<<grid, threads, 0, stream>>>((const T*)x, (const float*)partial, slabs,
                                       (const float*)scale, (const float*)bias, (T*)y, hw,
                                       c, groups, rows_per_slab, eps);
}

}  // namespace gn

// dtype: 1 for bf16, 0 for fp32. partial: [B, slabs, 2, C] fp32, slabs =
// ceil(hw / rows_per_slab).
extern "C" int group_norm_stats_launch(const void* x, void* partial, int dtype, int batch,
                                       int hw, int c, int rows_per_slab, void* stream) {
  if (c % gn::kVec || c > gn::kMaxC) return (int)cudaErrorInvalidValue;
  dim3 grid((hw + rows_per_slab - 1) / rows_per_slab, batch);
  const int threads = gn::block_threads(c);
  if (dtype == 1)
    gn::stats_kernel<__nv_bfloat16><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (float*)partial, hw, c, rows_per_slab);
  else
    gn::stats_kernel<float><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)partial, hw, c, rows_per_slab);
  return (int)cudaGetLastError();
}

// partial: [B, slabs, 2, C] from group_norm_stats; scale, bias: [C] fp32;
// y: like x (channels_last). The grid is the stats kernel's for the same
// rows_per_slab.
extern "C" int group_norm_apply_launch(const void* x, const void* partial, int slabs,
                                       const void* scale, const void* bias, void* y,
                                       int dtype, int batch, int hw, int c, int groups,
                                       int rows_per_slab, float eps, int silu, void* stream) {
  if (c % gn::kVec || c > gn::kMaxC || groups <= 0 || c % groups)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    gn::launch_apply<__nv_bfloat16>(x, partial, slabs, scale, bias, y, batch, hw, c, groups,
                                    rows_per_slab, eps, silu, (cudaStream_t)stream);
  else
    gn::launch_apply<float>(x, partial, slabs, scale, bias, y, batch, hw, c, groups,
                            rows_per_slab, eps, silu, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
