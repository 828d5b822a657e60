// small_attention: o = softmax(q k^T * scale) v per head for N <= 1024,
// head_dim 64, bf16 in and out, with the softmax weights normalised and then
// rounded to bf16 before P.V.
//
// Replaces the TPU kernel
// deepl_project_tpu/ops/pallas/small_attention.py::_kernel (_forward): one
// program per (image, head) holds the whole fp32 [N, N] score block (4 MB at
// N=1024) in VMEM, takes the exact row max and sum, forms p = exp(s - m) / l,
// rounds p to bf16 and multiplies by v with fp32 accumulation.
//
// The rounding point is what sets it apart from the flash kernels, which round
// the *unnormalised* p and divide o at the end: here p is divided first and
// then rounded (small_attention.py:36, the port's plain core xla_attention).
// An SM's 227 KB of shared memory cannot hold a head's 4 MB of scores, so the
// design runs two passes over k per 128-query tile, and keeps nothing of the
// scores between them:
//   pass 1: s = q k^T * scale tile by tile in registers; the running row max
//           m and the row sum l of exp(s - m), rescaled as m grows (the
//           online-softmax recurrence, exact up to fp32 rounding);
//   pass 2: s again, p = exp(s - m) * (1 / l) rounded to bf16, o += p v.
// Both passes use the tile code of flash_fwd_tile.cuh: eight warps of 16
// query rows, 64-key tiles double-buffered through cp.async (pass 1 streams
// only k, pass 2 k and v), scores as mma.sync accumulators whose layout is
// the A-fragment layout of P.V, so p never leaves registers.
//
// Bound on an H100: at 512px stage 4 (8 images, 24 heads, N=1024) the
// function needs 4*B*h*N^2*64 = 51.5 GFLOP against 0.1 GB moved, so the tensor
// cores bound it (0.052 ms); the recomputed q k^T of pass 1 adds half again
// to the operations the kernel issues.
//
// q, k, v: [B*N, ld_*] rows (each tensor with its own row stride), head h at
// columns h*64..; o: [B*N, ld_o]. N % 64 == 0.
#include "flash_fwd_tile.cuh"

namespace small {

using flash::FwdSmem;
using flash::kBKV;
using flash::kBQ;
using flash::kHD;
using flash::kThreads;

__global__ __launch_bounds__(kThreads, 2) void small_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int N, int ld_q, int ld_k,
    int ld_v, int ld_o, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBQ, hc = blockIdx.y * kHD;
  const size_t tok0 = (size_t)blockIdx.z * N;
  const int T = N / kBKV;  // key tiles per pass; step t < T is pass 1

  // Step t: key tile t % T into stage t & 1, and its v tile in pass 2.
  auto issue = [&](int t) {
    const int s = t & 1, kt = t < T ? t : t - T;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, cv = id & 7;
      const size_t row = tok0 + kt * kBKV + r;
      cp_async16(&sm.k[s][r][cv * 8], k + row * ld_k + hc + cv * 8, 16);
      if (t >= T) cp_async16(&sm.v[s][r][cv * 8], v + row * ld_v + hc + cv * 8, 16);
    }
  };
  // Q rows past N (a last, half-full tile) read zeros and are not stored.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * kThreads, r = id >> 3, cv = id & 7;
    const bool ok = q0 + r < N;
    cp_async16(&sm.q[r][cv * 8], q + (tok0 + (ok ? q0 + r : 0)) * ld_q + hc + cv * 8,
               ok ? 16 : 0);
  }
  issue(0);
  cp_async_commit();

  uint32_t qa[4][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float oacc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[nt][i] = 0.f;

  for (int t = 0; t < 2 * T; ++t) {
    const int s = t & 1;
    if (t + 1 < 2 * T) issue(t + 1);  // stage s^1 was freed by the barrier below
    cp_async_commit();
    cp_async_wait<1>();  // step t's tiles (and q) landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        ldmatrix_x4(qa[kc], &sm.q[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
    }

    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // b0, b1 of key tiles 2np and 2np+1
        ldmatrix_x4(b, &sm.k[s][np * 16 + (lane & 7) + (lane >> 4) * 8]
                            [kc * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16_16816(sc[2 * np], qa[kc], b[0], b[1]);
        mma_bf16_16816(sc[2 * np + 1], qa[kc], b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] *= scale_log2;

    if (t < T) {
      // Pass 1: the row max (quad-reduced, so the four threads of a row agree)
      // and each thread's share of the row sum, rescaled as the max grows.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        rs0 += exp2f(sc[nt][0] - mn0) + exp2f(sc[nt][1] - mn0);
        rs1 += exp2f(sc[nt][2] - mn1) + exp2f(sc[nt][3] - mn1);
      }
      l0 = l0 * exp2f(m0 - mn0) + rs0;
      l1 = l1 * exp2f(m1 - mn1) + rs1;
      m0 = mn0;
      m1 = mn1;
      if (t == T - 1) {  // the whole row is seen: l0, l1 become 1 / row sum
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, off);
          l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        l0 = 1.f / l0;
        l1 = 1.f / l1;
      }
    } else {
      // Pass 2: the normalised weights, rounded to bf16, times v.
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {  // 16 keys at a time
        uint32_t pa[4];
        pa[0] = pack_bf16(exp2f(sc[2 * kc][0] - m0) * l0, exp2f(sc[2 * kc][1] - m0) * l0);
        pa[1] = pack_bf16(exp2f(sc[2 * kc][2] - m1) * l1, exp2f(sc[2 * kc][3] - m1) * l1);
        pa[2] = pack_bf16(exp2f(sc[2 * kc + 1][0] - m0) * l0,
                          exp2f(sc[2 * kc + 1][1] - m0) * l0);
        pa[3] = pack_bf16(exp2f(sc[2 * kc + 1][2] - m1) * l1,
                          exp2f(sc[2 * kc + 1][3] - m1) * l1);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];  // b0, b1 of dim tiles 2np and 2np+1
          ldmatrix_x4_trans(b, &sm.v[s][kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                    [np * 16 + (lane >> 4) * 8]);
          mma_bf16_16816(oacc[2 * np], pa, b[0], b[1]);
          mma_bf16_16816(oacc[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

  const int r0 = q0 + warp * 16 + gid;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    if (row >= N) continue;
    bf16* orow = o + (tok0 + row) * ld_o + hc;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<bf162*>(orow + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(oacc[nt][half * 2], oacc[nt][half * 2 + 1]);
    }
  }
}

}  // namespace small

extern "C" int small_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int N, int H, int ld_q,
                                      int ld_k, int ld_v, int ld_o, float scale,
                                      void* stream) {
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = allow_smem(small::small_attention_kernel, (int)sizeof(flash::FwdSmem));
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  dim3 grid((N + flash::kBQ - 1) / flash::kBQ, H, B);
  small::small_attention_kernel<<<grid, flash::kThreads, sizeof(flash::FwdSmem),
                                  (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, N, ld_q, ld_k, ld_v,
      ld_o, scale * flash::kLog2e);
  return (int)cudaGetLastError();
}
