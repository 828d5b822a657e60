// The attention forward shared by attention_core.cu and
// flash_attention_fwd.cu: non-causal o = softmax(q k^T * scale) v per head,
// head_dim 64, bf16 in, fp32 scores and softmax, bf16 out, and optionally the
// per-row logsumexp (natural log, fp32).
//
// q, k, v: token-major rows ([B*N, ld_*], each with its own row stride) with
// head h at columns h*64 .. h*64+63; o: [B*N, ld_o]. lse: [B, H, N] fp32.
// N % 64 == 0; the last 128-query tile may be half full.
//
// Design (FlashAttention-2 style): one CTA per (q tile of 128, head, image),
// eight warps of 16 query rows; k/v tiles of 64 keys stream through a
// double-buffered cp.async pipeline; scores stay in registers as mma.sync
// accumulators, whose layout is the A-fragment layout of the P.V product, so
// P never leaves registers; v's B fragments come from ldmatrix.trans of the
// row-major tile. Online softmax in the exp2 domain; the row sums are kept
// per thread and reduced across the quad once at the end. P is rounded to
// bf16 unnormalised and o divided by the row sum at the end, as in the TPU
// _flash_kernel.
#pragma once

#include "tile_mma.cuh"

namespace flash {

constexpr int kHD = 64;
constexpr int kBQ = 128;
constexpr int kBKV = 64;
constexpr int kLD = kHD + 8;  // padded rows (144 B): conflict-free ldmatrix
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdSmem {
  bf16 q[kBQ][kLD];
  bf16 k[2][kBKV][kLD];
  bf16 v[2][kBKV][kLD];
};

template <bool kLSE>
__global__ __launch_bounds__(kThreads, 2) void fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int N, int ld_q, int ld_k, int ld_v, int ld_o, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBQ, hc = blockIdx.y * kHD;
  const size_t tok0 = (size_t)blockIdx.z * N;

  // Tile t of k and v into stage t & 1: 2 x 64 rows x 8 vectors of 16 bytes.
  auto issue_kv = [&](int t) {
    const int s = t & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, cv = id & 7;
      const size_t row = tok0 + t * kBKV + r;
      cp_async16(&sm.k[s][r][cv * 8], k + row * ld_k + hc + cv * 8, 16);
      cp_async16(&sm.v[s][r][cv * 8], v + row * ld_v + hc + cv * 8, 16);
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
  issue_kv(0);
  cp_async_commit();

  uint32_t qa[4][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float oacc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[nt][i] = 0.f;

  const int T = N / kBKV;
  for (int t = 0; t < T; ++t) {
    const int s = t & 1;
    if (t + 1 < T) issue_kv(t + 1);  // stage s^1 was freed by the barrier below
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) landed
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

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] *= scale_log2;
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt][0] = exp2f(sc[nt][0] - m0);
      sc[nt][1] = exp2f(sc[nt][1] - m0);
      sc[nt][2] = exp2f(sc[nt][2] - m1);
      sc[nt][3] = exp2f(sc[nt][3] - m1);
      rs0 += sc[nt][0] + sc[nt][1];
      rs1 += sc[nt][2] + sc[nt][3];
      oacc[nt][0] *= al0;
      oacc[nt][1] *= al0;
      oacc[nt][2] *= al1;
      oacc[nt][3] *= al1;
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;

#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // 16 keys at a time
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // b0, b1 of dim tiles 2np and 2np+1
        ldmatrix_x4_trans(b, &sm.v[s][kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                  [np * 16 + (lane >> 4) * 8]);
        mma_bf16_16816(oacc[2 * np], pa, b[0], b[1]);
        mma_bf16_16816(oacc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + gid;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    if (row >= N) continue;
    const float inv = half ? inv1 : inv0;
    bf16* orow = o + (tok0 + row) * ld_o + hc;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<bf162*>(orow + nt * 8 + tig * 2) = __floats2bfloat162_rn(
          oacc[nt][half * 2] * inv, oacc[nt][half * 2 + 1] * inv);
    }
    if constexpr (kLSE) {
      // m is in the scaled log2 domain: lse = (m + log2 l) * ln 2.
      if (tig == 0)
        lse[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * N + row] =
            ((half ? m1 : m0) + log2f(half ? l1 : l0)) * kLn2;
    }
  }
}

// Launch fwd_kernel<kLSE> on a (ceil(N/128), H, B) grid.
template <bool kLSE>
inline int fwd_launch(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int N, int H, int ld_q, int ld_k,
                      int ld_v, int ld_o, float scale, void* stream) {
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = allow_smem(fwd_kernel<kLSE>, (int)sizeof(FwdSmem));
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  dim3 grid((N + kBQ - 1) / kBQ, H, B);
  fwd_kernel<kLSE><<<grid, kThreads, sizeof(FwdSmem), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, N, ld_q,
      ld_k, ld_v, ld_o, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace flash
