// flash_attention_bwd_dkv: the key and value gradients of
// o = softmax(q k^T * scale) v, head_dim 64, bf16 in and out.
//
// Replaces the TPU kernel
// deepl_project_tpu/ops/pallas/flash_attention.py::_flash_bwd_dkv_kernel:
// for each query tile, p = exp(q k^T * scale - lse) (fp32),
// dv += bf16(p)^T dO, dp = dO v^T, ds = p * (dp - delta) * scale,
// dk += bf16(ds)^T q, with delta = rowsum(dO * o) computed beside the kernel.
//
// q, k, v, dO: [B*N, ld_*] rows with head h at columns h*64..; lse, delta:
// [B, H, N] fp32; dk, dv: [B*N, ld_out]. N % 64 == 0.
//
// Bound on an H100: 8*BH*N^2*64 FLOP (four products per tile pair; 412
// GFLOP at the training shape, 8 images x 6 heads, N=4096), so the tensor
// cores bound it (0.42 ms). Design: one CTA per (64-key tile, head, image),
// four warps of 16 key rows; the transposed problem is computed directly --
// s^T = k q^T and dp^T = v dO^T with k and v fragments held in registers for
// the whole query loop, so p^T and ds^T come out of the accumulators in the
// A-fragment layout of dv += p^T dO and dk += ds^T q. The dk/dv sums stay in
// registers for the whole loop (no atomics); 64-query q/dO tiles and their
// lse/delta slices are double-buffered through cp.async.
#include "tile_mma.cuh"

namespace {

constexpr int kHD = 64;
constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kLD = kHD + 8;  // padded rows (144 B): conflict-free ldmatrix
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  bf16 k[kBKV][kLD];
  bf16 v[kBKV][kLD];
  bf16 q[2][kBQ][kLD];
  bf16 g[2][kBQ][kLD];
  float lse[2][kBQ];
  float delta[2][kBQ];
};

__global__ __launch_bounds__(kThreads) void flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int ld_q, int ld_k,
    int ld_v, int ld_g, int ld_out, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kBKV, hc = blockIdx.y * kHD;
  const size_t tok0 = (size_t)blockIdx.z * N;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;

  auto issue_q = [&](int t) {  // 64 rows x 8 vectors of q and dO, + lse/delta
    const int s = t & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, cv = id & 7;
      const size_t row = tok0 + t * kBQ + r;
      cp_async16(&sm.q[s][r][cv * 8], q + row * ld_q + hc + cv * 8, 16);
      cp_async16(&sm.g[s][r][cv * 8], g + row * ld_g + hc + cv * 8, 16);
    }
    if (tid < 16)
      cp_async16(&sm.lse[s][tid * 4], lse + bh * N + t * kBQ + tid * 4, 16);
    else if (tid < 32)
      cp_async16(&sm.delta[s][(tid - 16) * 4], delta + bh * N + t * kBQ + (tid - 16) * 4, 16);
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * kThreads, r = id >> 3, cv = id & 7;
    const size_t row = tok0 + k0 + r;
    cp_async16(&sm.k[r][cv * 8], k + row * ld_k + hc + cv * 8, 16);
    cp_async16(&sm.v[r][cv * 8], v + row * ld_v + hc + cv * 8, 16);
  }
  issue_q(0);
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  uint32_t ka[4][4], va[4][4];
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;

  const int T = N / kBQ;
  for (int t = 0; t < T; ++t) {
    const int s = t & 1;
    if (t + 1 < T) issue_q(t + 1);  // stage s^1 was freed by the barrier below
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and k, v) landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        ldmatrix_x4(ka[kc], &sm.k[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
        ldmatrix_x4(va[kc], &sm.v[warp * 16 + (lane & 15)][kc * 16 + (lane >> 4) * 8]);
      }
    }

    // st[nt][i]: key row warp*16 + gid (+8 for i >= 2), query nt*8 + 2tig + (i & 1).
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kc * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];  // b0, b1 of query tiles 2np and 2np+1
        ldmatrix_x4(b, &sm.q[s][r][c]);
        mma_bf16_16816(st[2 * np], ka[kc], b[0], b[1]);
        mma_bf16_16816(st[2 * np + 1], ka[kc], b[2], b[3]);
        ldmatrix_x4(b, &sm.g[s][r][c]);
        mma_bf16_16816(dpt[2 * np], va[kc], b[0], b[1]);
        mma_bf16_16816(dpt[2 * np + 1], va[kc], b[2], b[3]);
      }
    }
    // p^T in st, ds^T = p^T * (dp^T - delta) * scale in dpt.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + tig * 2 + (i & 1);
        const float p = exp2f(st[nt][i] * scale_log2 - sm.lse[s][col] * kLog2e);
        st[nt][i] = p;
        dpt[nt][i] = p * (dpt[nt][i] - sm.delta[s][col]) * scale;
      }
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // 16 queries at a time
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(st[2 * kc][0], st[2 * kc][1]);
      pa[1] = pack_bf16(st[2 * kc][2], st[2 * kc][3]);
      pa[2] = pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]);
      pa[3] = pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3]);
      da[0] = pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]);
      da[1] = pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]);
      da[2] = pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]);
      da[3] = pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int r = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = np * 16 + (lane >> 4) * 8;
        uint32_t b[4];  // b0, b1 of dim tiles 2np and 2np+1
        ldmatrix_x4_trans(b, &sm.g[s][r][c]);
        mma_bf16_16816(dva[2 * np], pa, b[0], b[1]);
        mma_bf16_16816(dva[2 * np + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, &sm.q[s][r][c]);
        mma_bf16_16816(dka[2 * np], da, b[0], b[1]);
        mma_bf16_16816(dka[2 * np + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

  const int r_lo = k0 + warp * 16 + gid;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const size_t off = (tok0 + r_lo + half * 8) * ld_out + hc;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<bf162*>(dk + off + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(dka[nt][half * 2], dka[nt][half * 2 + 1]);
      *reinterpret_cast<bf162*>(dv + off + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(dva[nt][half * 2], dva[nt][half * 2 + 1]);
    }
  }
}

}  // namespace

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dk, void* dv, int B, int N,
    int H, int ld_q, int ld_k, int ld_v, int ld_g, int ld_out, float scale,
    void* stream) {
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = allow_smem(flash_bwd_dkv_kernel, (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  dim3 grid(N / kBKV, H, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, sizeof(Smem), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, N, ld_q,
      ld_k, ld_v, ld_g, ld_out, scale);
  return (int)cudaGetLastError();
}
