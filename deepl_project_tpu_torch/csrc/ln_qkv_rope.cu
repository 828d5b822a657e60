// ln_qkv_rope: LayerNorm statistics + three per-branch affines + the Q/K/V
// projections + 2D RoPE, as one GEMM with an LN prologue and a RoPE epilogue.
//
// Replaces the TPU kernels deepl_project_tpu/ops/pallas/
// fused_attention_block.py::fused_qkv_rope (_qkv_rope_kernel), whole, and the
// first half of ::_forward (_kernel: LN trio, projections, RoPE).
//
//   out[m, :] = [ rope(bf16(xt_q[m] @ Wq[:, perm])) |
//                 rope(bf16(xt_k[m] @ Wk[:, perm])) | bf16(xt_v[m] @ Wv) ]
//   xt_i[m]   = bf16(bf16((x[m] - mean_m) * rstd_m) * g_i + b_i)
//
// x [M, C] bf16 (M = B*N tokens), w [3C, C] bf16 (rows: q and k output
// channels permuted per head to [evens | odds], then v), gb [6, C] fp32
// (gq, bq, gk, bk, gv, bv), RoPE tables [N, 32] fp32, out [M, 3C] bf16.
// head_dim is 64: a warp's 64 output columns are exactly one head, so the
// rotation pairs column j with j + 32 inside one thread's registers.
//
// Bound on an H100: at the main path's shapes (large@256, b32) the GEMM does
// 2*M*C*3C = 116 GFLOP against about 0.4 GB of traffic, i.e. near the ridge
// of the bf16 roofline (0.12 ms each way). Design: 128x128x32 tiles on
// mma.sync with fp32 accumulation, a 4-stage cp.async pipeline, ldmatrix
// fragment loads. The LN transform rewrites each landed A tile in shared
// memory, so x-hat never exists in device memory; RoPE runs on the
// accumulators before the only store. A CTA covers several column tiles of
// one row block, so its row statistics (one pass, shifted by the row's first
// element) are computed once for all of them.
#include "tile_mma.cuh"

namespace {

constexpr int kHeadDim = 64;

// Writes a warp's 32x64 accumulator tile (one head) to out (row stride ldo)
// from row `row0`: rounded to bf16, then, with `rope`, rotated in fp32 --
// column j < 32 pairs with j + 32 in the same thread's registers.
__device__ __forceinline__ void store_tile(
    const float (&acc)[2][8][4], bf16* __restrict__ out, int ldo, int row0, int M,
    int N, bool rope, const float* __restrict__ ca, const float* __restrict__ sa,
    const float* __restrict__ cb, const float* __restrict__ sb) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + mt * 16 + gid + half * 8;
      if (row >= M) continue;
      bf16* orow = out + (size_t)row * ldo;
      if (rope) {
        const int n = row % N;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int j = nt * 8 + tig * 2;  // position in the even half
          const float2 ca2 = *reinterpret_cast<const float2*>(ca + n * 32 + j);
          const float2 sa2 = *reinterpret_cast<const float2*>(sa + n * 32 + j);
          const float2 cb2 = *reinterpret_cast<const float2*>(cb + n * 32 + j);
          const float2 sb2 = *reinterpret_cast<const float2*>(sb + n * 32 + j);
          const float e0 = round_bf16(acc[mt][nt][half * 2]);
          const float e1 = round_bf16(acc[mt][nt][half * 2 + 1]);
          const float o0 = round_bf16(acc[mt][nt + 4][half * 2]);
          const float o1 = round_bf16(acc[mt][nt + 4][half * 2 + 1]);
          *reinterpret_cast<bf162*>(orow + j) = __floats2bfloat162_rn(
              e0 * ca2.x - o0 * sa2.x, e1 * ca2.y - o1 * sa2.y);
          *reinterpret_cast<bf162*>(orow + 32 + j) = __floats2bfloat162_rn(
              e0 * sb2.x + o0 * cb2.x, e1 * sb2.y + o1 * cb2.y);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          *reinterpret_cast<bf162*>(orow + nt * 8 + tig * 2) = __floats2bfloat162_rn(
              acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
        }
      }
    }
  }
}

__global__ __launch_bounds__(tile::THREADS, 2) void ln_qkv_rope_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ gb, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ cb,
    const float* __restrict__ sb, bf16* __restrict__ out, int M, int N, int C,
    int use_rope, int tiles_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tile::Smem& sm = *reinterpret_cast<tile::Smem*>(smem_raw);
  __shared__ float s_mean[tile::BM], s_rstd[tile::BM];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.y * tile::BM;

  // Row statistics in fp32, one pass: sums of (x - x0) and (x - x0)^2 with
  // x0 the row's first element, which keeps E[d^2] - E[d]^2 free of
  // cancellation when the row mean is large against its spread.
  for (int r = warp; r < tile::BM; r += tile::THREADS / 32) {
    const int row = row0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < M) {
      const bf16* xr = x + (size_t)row * C;
      const float shift = __bfloat162float(xr[0]);
      float s1 = 0.f, s2 = 0.f;
      for (int v = lane; v < C / 8; v += 32) {
        uint4 u = reinterpret_cast<const uint4*>(xr)[v];
        const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = __bfloat162float(e[j]) - shift;
          s1 += d;
          s2 += d * d;
        }
      }
      const float m1 = warp_sum(s1) / C;
      mean = shift + m1;
      rstd = rsqrtf(fmaxf(warp_sum(s2) / C - m1 * m1, 0.f) + 1e-5f);
    }
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
    }
  }
  // (The main loop's opening barrier publishes the statistics.)

  for (int t = 0; t < tiles_per_cta; ++t) {
    const int col0 = (blockIdx.x * tiles_per_cta + t) * tile::BN;
    const int branch = col0 / C;  // 0 = q, 1 = k, 2 = v (C % 128 == 0)
    tile::APrologue<true> pro{s_mean, s_rstd, gb + (2 * branch) * C,
                              gb + (2 * branch + 1) * C};
    float acc[2][8][4];
    tile::gemm_mainloop<true>(sm, x, C, w, C, M, row0, col0, pro, acc);
    store_tile(acc, out + col0 + wn * kHeadDim, 3 * C, row0 + wm * 32, M, N,
               use_rope && branch < 2, ca, sa, cb, sb);
  }
}

}  // namespace

extern "C" int ln_qkv_rope_launch(const void* x, const void* w, const void* gb,
                                  const void* ca, const void* sa,
                                  const void* cb, const void* sb, void* out,
                                  int M, int N, int C, int use_rope,
                                  void* stream) {
  static int sms = 0;
  if (sms == 0) {
    cudaError_t e = allow_smem(ln_qkv_rope_kernel, tile::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms = n;
  }
  // Column tiles per CTA: as many as keep >= 4 CTAs per SM in the grid (two
  // resident, two more waves), so the row statistics are shared widely.
  const int col_tiles = 3 * C / tile::BN, row_tiles = (M + tile::BM - 1) / tile::BM;
  int per = 1;
  for (int t = col_tiles; t >= 1; --t) {
    if (col_tiles % t == 0 && (col_tiles / t) * row_tiles >= 4 * sms) {
      per = t;
      break;
    }
  }
  dim3 grid(col_tiles / per, row_tiles);
  ln_qkv_rope_kernel<<<grid, tile::THREADS, tile::kSmemBytes, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)gb, (const float*)ca,
      (const float*)sa, (const float*)cb, (const float*)sb, (bf16*)out, M, N,
      C, use_rope, per);
  return (int)cudaGetLastError();
}
