// group_norm_silu: GroupNorm (fp32 single-pass moments) then SiLU on an
// NCHW tensor, bf16 or fp32, as two kernels with a tiny epilogue between them
// in torch:
//
//   group_norm_stats: per (image, group, chunk) the partial sums sum(x) and
//                     sum(x^2) in fp32 -> partial [B*G, splits, 2];
//   (torch)           sums over the chunks, mean, var = max(E[x^2] - mean^2,
//                     0), rsqrt(var + eps), per-channel mul and add;
//   group_norm_apply: y = silu(x * mul[b, c] + add[b, c]) in fp32, written in
//                     x's dtype.
//
// Replaces the TPU kernels
// deepl_project_tpu/ops/pallas/fused_norm.py::_stats_kernel and
// ::_apply_kernel (group_norm_silu). The TPU runs its grid in order and adds
// each row block's per-channel sums into one revisited [2, C] block. CUDA
// blocks run in parallel in no order, so the sums are a two-level reduction
// without atomics: each block reduces one contiguous chunk of one group
// (in NCHW a group of one image is contiguous: C/G planes of H*W values) and
// writes its own partial pair, and the epilogue adds the pairs. The result
// does not depend on the order the blocks ran in.
//
// Bound on an H100: memory. At large f16d32 256px stage 0 (32 images,
// C=192, 256x256, bf16) x is 805 MB: the stats kernel reads it once (0.24 ms
// at 3.35 TB/s), the apply kernel reads it once and writes y once (0.48 ms).
// Both move 16 bytes a thread per load (8 bf16 or 2 x 4 fp32), with the
// neighbouring threads on neighbouring addresses.
//
// Requires x 16-byte aligned and H*W % 8 == 0, so that a vector of 8 values
// never crosses a plane (one channel of one image) or a group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // values per thread per load

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Grid (splits, B*G): block (s, bg) reduces values [s*chunk, (s+1)*chunk) of
// group bg (group_elems values from x + bg*group_elems); chunk % 8 == 0.
template <typename T>
__global__ __launch_bounds__(kThreads) void stats_kernel(
    const T* __restrict__ x, float* __restrict__ partial, long long group_elems,
    long long chunk) {
  const T* base = x + (size_t)blockIdx.y * group_elems;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(start + chunk, group_elems);
  float s1 = 0.f, s2 = 0.f;
  for (long long i = start + (long long)threadIdx.x * kVec; i < end;
       i += (long long)kThreads * kVec) {
    float v[kVec];
    load8(base + i, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1 += v[j];
      s2 += v[j] * v[j];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  __shared__ float red[2][kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    float* out = partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2;
    out[0] = a;
    out[1] = b;
  }
}

// Grid-stride over vectors of 8 values; plane (b*C + c) = value index / hw.
template <typename T>
__global__ __launch_bounds__(kThreads) void apply_kernel(
    const T* __restrict__ x, const float* __restrict__ mul,
    const float* __restrict__ add, T* __restrict__ y, long long total,
    long long hw, int silu) {
  const long long nvec = total / kVec;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * kThreads) {
    const long long e = i * kVec;
    const long long plane = e / hw;
    const float m = __ldg(mul + plane), a = __ldg(add + plane);
    float v[kVec];
    load8(x + e, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float z = v[j] * m + a;
      v[j] = silu ? z / (1.f + expf(-z)) : z;
    }
    store8(y + e, v);
  }
}

}  // namespace gn

// dtype: 1 for bf16, 0 for fp32. partial: [B*G, splits, 2] fp32.
extern "C" int group_norm_stats_launch(const void* x, void* partial, int dtype,
                                       int groups_total, int splits,
                                       long long group_elems, long long chunk,
                                       void* stream) {
  dim3 grid(splits, groups_total);
  if (dtype == 1)
    gn::stats_kernel<__nv_bfloat16><<<grid, gn::kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (float*)partial, group_elems, chunk);
  else
    gn::stats_kernel<float><<<grid, gn::kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)partial, group_elems, chunk);
  return (int)cudaGetLastError();
}

// mul, add: [B*C] fp32; y: like x.
extern "C" int group_norm_apply_launch(const void* x, const void* mul, const void* add,
                                       void* y, int dtype, long long total,
                                       long long hw, int silu, int blocks,
                                       void* stream) {
  if (dtype == 1)
    gn::apply_kernel<__nv_bfloat16><<<blocks, gn::kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const float*)mul, (const float*)add,
        (__nv_bfloat16*)y, total, hw, silu);
  else
    gn::apply_kernel<float><<<blocks, gn::kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)mul, (const float*)add, (float*)y, total, hw,
        silu);
  return (int)cudaGetLastError();
}
