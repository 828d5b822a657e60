// proj_bias_gemm: out = bf16(o @ Wp + bp), fp32 accumulation and fp32 bias.
//
// Replaces the output projection inside the TPU kernel
// deepl_project_tpu/ops/pallas/fused_attention_block.py::_forward (_kernel's
// head-group accumulation into acc_ref and the bias add in _emit).
//
// o [M, K] bf16, w [Nout, K] bf16 (nn.Linear layout), bias [Nout] fp32,
// out [M, Nout] bf16; K % 32 == 0 and Nout % 128 == 0.
//
// Bound on an H100: at large@256 b32 the stage-3 and stage-4 products are
// 2*M*C*C = 38.7 GFLOP over about 0.1 GB, so the tensor cores bound it
// (0.04 ms). Design: the shared 128x128x32 mma.sync main loop (4-stage
// cp.async pipeline, ldmatrix fragments); the bias is added to the fp32
// accumulators before the single rounding to bf16, as the TPU kernel adds it
// to its fp32 accumulator.
#include "tile_mma.cuh"

namespace {

__global__ __launch_bounds__(tile::THREADS, 2) void proj_bias_gemm_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ w,
    const float* __restrict__ bias, bf16* __restrict__ out, int M, int K,
    int Nout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tile::Smem& sm = *reinterpret_cast<tile::Smem*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.y * tile::BM;
  const int col0 = blockIdx.x * tile::BN;

  tile::APrologue<false> pro{};
  float acc[2][8][4];
  tile::gemm_mainloop<false>(sm, a, K, w, K, M, row0, col0, pro, acc);

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 32 + mt * 16 + gid + half * 8;
      if (row >= M) continue;
      bf16* orow = out + (size_t)row * Nout;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = col0 + wn * 64 + nt * 8 + tig * 2;
        const float2 b2 = *reinterpret_cast<const float2*>(bias + col);
        *reinterpret_cast<bf162*>(orow + col) = __floats2bfloat162_rn(
            acc[mt][nt][half * 2] + b2.x, acc[mt][nt][half * 2 + 1] + b2.y);
      }
    }
  }
}

}  // namespace

extern "C" int proj_bias_gemm_launch(const void* a, const void* w,
                                     const void* bias, void* out, int M, int K,
                                     int Nout, void* stream) {
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = allow_smem(proj_bias_gemm_kernel, tile::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  dim3 grid(Nout / tile::BN, (M + tile::BM - 1) / tile::BM);
  proj_bias_gemm_kernel<<<grid, tile::THREADS, tile::kSmemBytes, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const float*)bias, (bf16*)out, M, K,
      Nout);
  return (int)cudaGetLastError();
}
