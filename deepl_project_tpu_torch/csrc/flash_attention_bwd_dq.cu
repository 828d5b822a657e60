// flash_attention_bwd_dq: the query gradient of o = softmax(q k^T * scale) v,
// head_dim 64, bf16 in and out.
//
// Replaces the TPU kernel
// deepl_project_tpu/ops/pallas/flash_attention.py::_flash_bwd_dq_kernel:
// for each key tile, s = q k^T * scale (fp32), p = exp(s - lse),
// dp = dO v^T (fp32), ds = p * (dp - delta) * scale, dq += bf16(ds) k, with
// delta = rowsum(dO * o) computed beside the kernel in fp32.
//
// q, k, v, dO: [B*N, ld_*] rows with head h at columns h*64..; lse, delta:
// [B, H, N] fp32; dq: [B*N, ld_dq]. N % 64 == 0.
//
// Bound on an H100: 6*BH*N^2*64 FLOP (three products per tile pair; 309
// GFLOP at the training shape, 8 images x 6 heads, N=4096) against a few
// MB per head, so the tensor cores bound it (0.31 ms). Design: one CTA per
// (64-query tile, head, image), four warps of 16 query rows; q and dO
// fragments stay in registers for the whole key loop; 64-key k/v tiles are
// double-buffered through cp.async. s and dp are mma.sync accumulators whose
// layout is the A-fragment layout of the ds.k product, so p and ds never
// leave registers; k's B fragments for that product come from ldmatrix.trans
// of the same row-major tile that fed q k^T.
#include "tile_mma.cuh"

namespace {

constexpr int kHD = 64;
constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kLD = kHD + 8;  // padded rows (144 B): conflict-free ldmatrix
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  bf16 q[kBQ][kLD];
  bf16 g[kBQ][kLD];
  bf16 k[2][kBKV][kLD];
  bf16 v[2][kBKV][kLD];
};

__global__ __launch_bounds__(kThreads) void flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int N, int ld_q, int ld_k, int ld_v, int ld_g,
    int ld_dq, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBQ, hc = blockIdx.y * kHD;
  const size_t tok0 = (size_t)blockIdx.z * N;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;

  auto issue_kv = [&](int t) {  // 64 rows x 8 vectors of k and of v
    const int s = t & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, cv = id & 7;
      const size_t row = tok0 + t * kBKV + r;
      cp_async16(&sm.k[s][r][cv * 8], k + row * ld_k + hc + cv * 8, 16);
      cp_async16(&sm.v[s][r][cv * 8], v + row * ld_v + hc + cv * 8, 16);
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * kThreads, r = id >> 3, cv = id & 7;
    const size_t row = tok0 + q0 + r;
    cp_async16(&sm.q[r][cv * 8], q + row * ld_q + hc + cv * 8, 16);
    cp_async16(&sm.g[r][cv * 8], g + row * ld_g + hc + cv * 8, 16);
  }
  issue_kv(0);
  cp_async_commit();

  // This thread's two query rows: r_lo and r_lo + 8.
  const int r_lo = q0 + warp * 16 + gid;
  const float L0 = lse[bh * N + r_lo] * kLog2e, L1 = lse[bh * N + r_lo + 8] * kLog2e;
  const float D0 = delta[bh * N + r_lo], D1 = delta[bh * N + r_lo + 8];
  const float scale_log2 = scale * kLog2e;

  uint32_t qa[4][4], ga[4][4];
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  const int T = N / kBKV;
  for (int t = 0; t < T; ++t) {
    const int s = t & 1;
    if (t + 1 < T) issue_kv(t + 1);  // stage s^1 was freed by the barrier below
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q, dO) landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        ldmatrix_x4(qa[kc], &sm.q[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
        ldmatrix_x4(ga[kc], &sm.g[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
      }
    }

    float sc[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kc * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];  // b0, b1 of key tiles 2np and 2np+1
        ldmatrix_x4(b, &sm.k[s][r][c]);
        mma_bf16_16816(sc[2 * np], qa[kc], b[0], b[1]);
        mma_bf16_16816(sc[2 * np + 1], qa[kc], b[2], b[3]);
        ldmatrix_x4(b, &sm.v[s][r][c]);
        mma_bf16_16816(dp[2 * np], ga[kc], b[0], b[1]);
        mma_bf16_16816(dp[2 * np + 1], ga[kc], b[2], b[3]);
      }
    }
    // ds = p * (dp - delta) * scale, in place of the scores.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(sc[nt][i] * scale_log2 - (i < 2 ? L0 : L1));
        sc[nt][i] = p * (dp[nt][i] - (i < 2 ? D0 : D1)) * scale;
      }
    }
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
        ldmatrix_x4_trans(b, &sm.k[s][kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                  [np * 16 + (lane >> 4) * 8]);
        mma_bf16_16816(acc[2 * np], pa, b[0], b[1]);
        mma_bf16_16816(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* row = dq + (tok0 + r_lo + half * 8) * ld_dq + hc;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<bf162*>(row + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[nt][half * 2], acc[nt][half * 2 + 1]);
  }
}

}  // namespace

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, int B, int N, int H,
    int ld_q, int ld_k, int ld_v, int ld_g, int ld_dq, float scale,
    void* stream) {
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = allow_smem(flash_bwd_dq_kernel, (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  dim3 grid(N / kBQ, H, B);
  flash_bwd_dq_kernel<<<grid, kThreads, sizeof(Smem), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)delta, (bf16*)dq, N, ld_q, ld_k, ld_v,
      ld_g, ld_dq, scale);
  return (int)cudaGetLastError();
}
