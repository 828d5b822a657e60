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
// x [M, C] bf16 (M = B*N tokens), w [3Wp, C] bf16 (rows: q and k output
// channels permuted per head to [evens | odds], then v, each branch padded
// with zero rows from W to Wp), gb [6, C] fp32 (gq, bq, gk, bk, gv, bv),
// RoPE tables [N, 32] fp32, out [M, 3W] bf16, xhat [M, C] bf16 scratch.
// C % 128 == 0; M need not be a multiple of the tile. head_dim is 64: column
// j of a head's even half pairs with j + 32, which lies in the same thread's
// accumulators.
//
// W is the width of the heads computed: C for the whole layer, C / m for one
// rank's heads under tensor parallelism (W % 64 == 0, W <= C). A 128-column
// tile must lie in one branch (its LN affine and whether RoPE applies are
// the branch's), so each branch is padded to Wp = W rounded up to 128: the
// pad rows of w are zero and the epilogue stores no 64-column box past W.
// At W % 128 == 64 (W = 192: stage 2 of large at m = 2) that costs a third
// more GEMM work than the 3W columns need; elsewhere Wp = W.
//
// Bound on an H100: at the main path's shapes (large@256, b32) the GEMM does
// 2*M*C*3C = 116 GFLOP against about 0.4 GB of traffic, near the ridge of the
// bf16 roofline (0.12 ms each way); only wgmma reaches that rate. Design:
//
// 1. A normalisation pass (one warp a row, in fp32: the mean, then the mean
//    of squared deviations, as the plain version) writes xhat =
//    bf16((x - mean) * rstd), the rounding point the three branches share.
//    The GEMM rewrites each x tile once per column tile (3C / 128 times), so
//    the shared part is done here once: with the row statistics kept in the
//    GEMM instead, the kernel took 3-9% longer (PERF.md).
// 2. The GEMM is proj_bias_gemm's: one persistent CTA per SM walks 256 x 128
//    output tiles row block first (a 128-column tile lies in one of the q/k/v
//    branches), one producer thread keeps a ring of 64-deep xhat and W stages
//    full with TMA (128-byte swizzle, zero fill past M), and two consumer
//    warpgroups of 128 rows run m64n128k16 wgmma from shared memory.
// 3. The LN prologue runs in shared memory, in place: once a stage's xhat
//    tile has landed, each consumer thread rewrites 8 rows x one 16-byte chunk
//    of its warpgroup's rows to the branch's xt = bf16(xhat * g + b), then a
//    proxy fence and a named barrier over the warpgroup hand the stage to
//    wgmma. The products of stage s stay in flight while stage s+1 is
//    rewritten.
// 4. The RoPE epilogue runs on the accumulators: rounded to bf16, rotated in
//    fp32 with the table row of each token, rounded again, then written into a
//    swizzled staging tile and stored by TMA (which clips rows past M).
#include "hopper_tma_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int BM = 256;  // rows of a tile: two consumer warpgroups of 128
constexpr int BN = 128;  // columns of a tile: two heads of one branch
constexpr int BK = 64;   // depth of a stage (one 128-byte swizzled row)
constexpr int STAGES = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = BM * BK * 2;  // 32 KB
constexpr int kBBytes = BN * BK * 2;  // 16 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBytes = 64 * BN * 2;  // 16 KB: a consumer's 64-row half, two 64-column boxes
constexpr int kSmemBytes = STAGES * kStageBytes + kConsumers * kOutBytes + 2 * STAGES * 8 + 1024;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// xhat = bf16((x - mean) * rstd) of each row of x [M, C]: one warp a row, 8
// rows a block.
__global__ __launch_bounds__(256) void ln_hat_kernel(const bf16* __restrict__ x,
                                                      bf16* __restrict__ xhat, int M, int C) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float s = 0.f;
  for (int v = lane; v < C / 8; v += 32) {
    const uint4 u = __ldg(xr + v);
    s += lo_bf16(u.x) + hi_bf16(u.x) + lo_bf16(u.y) + hi_bf16(u.y) + lo_bf16(u.z) +
         hi_bf16(u.z) + lo_bf16(u.w) + hi_bf16(u.w);
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
  for (int v = lane; v < C / 8; v += 32) {
    const uint4 u = __ldg(xr + v);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = lo_bf16(w[i]) - mean, b = hi_bf16(w[i]) - mean;
      q += a * a + b * b;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / C + kEps);
  uint4* xo = reinterpret_cast<uint4*>(xhat + (size_t)row * C);
  for (int v = lane; v < C / 8; v += 32) {
    const uint4 u = __ldg(xr + v);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = pack_bf16((lo_bf16(w[i]) - mean) * rstd, (hi_bf16(w[i]) - mean) * rstd);
    xo[v] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Rewrite one 16-byte chunk (8 values of one row) of xhat in shared memory
// to bf16(xhat * g + b).
__device__ __forceinline__ void ln_chunk(unsigned char* p, const float4 (&g)[2],
                                         const float4 (&b)[2]) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const float gg[8] = {g[0].x, g[0].y, g[0].z, g[0].w, g[1].x, g[1].y, g[1].z, g[1].w};
  const float bb[8] = {b[0].x, b[0].y, b[0].z, b[0].w, b[1].x, b[1].y, b[1].z, b[1].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = pack_bf16(lo_bf16(w[i]) * gg[2 * i] + bb[2 * i],
                     hi_bf16(w[i]) * gg[2 * i + 1] + bb[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ __launch_bounds__(kThreads, 1) void ln_qkv_rope_kernel(
    __grid_constant__ const CUtensorMap tm_xhat, __grid_constant__ const CUtensorMap tm_w,
    __grid_constant__ const CUtensorMap tm_out,
    const float* __restrict__ gb, const float* __restrict__ ca, const float* __restrict__ sa,
    const float* __restrict__ cb, const float* __restrict__ sb, int M, int N, int C,
    int W, int use_rope) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* staging = smem + STAGES * kStageBytes;  // kOutBytes a consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kConsumers * kOutBytes);
  uint64_t* empty = full + STAGES;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int Wp = (W + BN - 1) / BN * BN;  // a branch's padded width
  const int tiles_n = 3 * Wp / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int KT = C / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warpgroup: one thread issues the TMA loads.
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = smem + s * kStageBytes;
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &tm_xhat, &full[s], kt * BK, m0);
          tma_load_2d(st + kABytes, &tm_w, &full[s], kt * BK, n0);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: rows wg*128 .. +127 of each tile, as two m64
    // halves sharing the W tile.
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gid = lane / 4, tig = lane % 4;
    // The LN prologue's share of a stage: logical chunk lc (columns 8lc..+7)
    // of rows r0 + 16i, i < 8, of this warpgroup's 128 rows. A quarter warp
    // covers one whole 128-byte row: no bank conflicts.
    const int lc = tid % 8, r0 = tid / 8;
    const int chunk_off = r0 * 128 + ((lc ^ (r0 % 8)) << 4);
    float acc[2][64];
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
      const int branch = n0 / Wp;  // 0 = q, 1 = k, 2 = v
      const float* g = gb + 2 * branch * C + lc * 8;  // this thread's columns
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        float4 g4[2], b4[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          g4[i] = __ldg(reinterpret_cast<const float4*>(g + kt * BK) + i);
          b4[i] = __ldg(reinterpret_cast<const float4*>(g + C + kt * BK) + i);
        }
        mbar_wait(&full[s], ph);
        unsigned char* stage = smem + s * kStageBytes;
        unsigned char* mine = stage + wg * 128 * 128;
#pragma unroll
        for (int i = 0; i < 8; ++i) ln_chunk(mine + chunk_off + i * 16 * 128, g4, b4);
        fence_proxy_async();  // the rewritten tile is visible to wgmma
        named_bar_sync(1 + wg, 128);
        const uint64_t da = desc_kmajor(mine);
        const uint64_t db = desc_kmajor(stage + kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const int add = kt > 0 || kk > 0;
          // +32 bytes per k slice; the second half starts 64 rows (8 KB) on.
          wgmma_m64n128k16_ss(acc[0], da + 2 * kk, db + 2 * kk, add);
          wgmma_m64n128k16_ss(acc[1], da + (64 * 128 >> 4) + 2 * kk, db + 2 * kk, add);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (kt > 0) mbar_arrive_if(&empty[prev], tid == 0);
        prev = s;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      // RoPE table values of this thread's rows, fetched ahead of their use:
      // buffer `half` holds (ca, sa, cb, sb) at the 4 even-half positions of
      // row (h, half); h = 0's are in flight under the last products.
      float2 tab[2][4][4];
      const int rbase = m0 + wg * 128 + warp * 16 + gid;
      auto fetch_tab = [&](float2 (&tb)[4][4], int grow) {
        const int n = grow % N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = n * 32 + 8 * j + 2 * tig;
          tb[j][0] = __ldg(reinterpret_cast<const float2*>(ca + p));
          tb[j][1] = __ldg(reinterpret_cast<const float2*>(sa + p));
          tb[j][2] = __ldg(reinterpret_cast<const float2*>(cb + p));
          tb[j][3] = __ldg(reinterpret_cast<const float2*>(sb + p));
        }
      };
      fetch_tab(tab[0], rbase);
      fetch_tab(tab[1], rbase + 8);
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive_if(&empty[prev], tid == 0);

      // Epilogue, one 64-row half at a time through this warpgroup's staging
      // tile: [2 boxes of 64 columns][64 rows][128 bytes], 16-byte chunk c
      // of row r at chunk c ^ (r % 8) (the store map's 128-byte swizzle).
      const bool rope = use_rope && branch < 2;
      unsigned char* stg = staging + wg * kOutBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tid == 0) bulk_wait_read<0>();  // the last store has read stg
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + half * 8 + gid;  // r % 8 == gid
          unsigned char* row = stg + r * 128 + tig * 4;
          const float* d = acc[h] + 2 * half;
          if (rope) {
            // The two heads of the tile share the token's table row.
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 ca2 = tab[half][j][0], sa2 = tab[half][j][1];
              const float2 cb2 = tab[half][j][2], sb2 = tab[half][j][3];
#pragma unroll
              for (int head = 0; head < 2; ++head) {
                const int je = 8 * head + j, jo = je + 4;  // 8-column groups
                const uint32_t e = pack_bf16(d[4 * je], d[4 * je + 1]);
                const uint32_t o = pack_bf16(d[4 * jo], d[4 * jo + 1]);
                const float e0 = lo_bf16(e), e1 = hi_bf16(e), o0 = lo_bf16(o), o1 = hi_bf16(o);
                *reinterpret_cast<uint32_t*>(row + head * 8192 + (((je % 8) ^ gid) << 4)) =
                    pack_bf16(e0 * ca2.x - o0 * sa2.x, e1 * ca2.y - o1 * sa2.y);
                *reinterpret_cast<uint32_t*>(row + head * 8192 + (((jo % 8) ^ gid) << 4)) =
                    pack_bf16(e0 * sb2.x + o0 * cb2.x, e1 * sb2.y + o1 * cb2.y);
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
              *reinterpret_cast<uint32_t*>(row + (j / 8) * 8192 + (((j % 8) ^ gid) << 4)) =
                  pack_bf16(d[4 * j], d[4 * j + 1]);
          }
          if (h == 0) fetch_tab(tab[half], rbase + 64 + 8 * half);
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (tid == 0) {
          // The tile's first column within its branch; a tile starts below
          // W (Wp - W < 128), its second 64-column box may be padding.
          const int rr = m0 + wg * 128 + h * 64, col = n0 - branch * Wp;
          tma_store_2d(&tm_out, stg, branch * W + col, rr);
          if (col + 64 < W) tma_store_2d(&tm_out, stg + 8192, branch * W + col + 64, rr);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait<0>();  // the stores are done before the CTA exits
  }
}

int launch(const void* x, const void* w, const void* gb, const void* ca, const void* sa,
           const void* cb, const void* sb, void* xhat, void* out, int M, int N, int C, int W,
           int use_rope, void* stream) {
  if (C % 128 || W % 64 || W <= 0 || W > C) return (int)cudaErrorInvalidValue;
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_qkv_rope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  // Maps are encoded on every call: the operands' addresses change.
  const int Wp = (W + BN - 1) / BN * BN;
  CUtensorMap tm_xhat, tm_w, tm_out;
  const cuuint64_t dims_x[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t dims_w[2] = {(cuuint64_t)C, (cuuint64_t)(3 * Wp)};
  const cuuint64_t dims_o[2] = {(cuuint64_t)(3 * W), (cuuint64_t)M};
  int e = hopper::make_map_bf16(&tm_xhat, xhat, 2, dims_x, (uint64_t)C * 2, 0, BM);
  if (e == 0) e = hopper::make_map_bf16(&tm_w, w, 2, dims_w, (uint64_t)C * 2, 0, BN);
  if (e == 0) e = hopper::make_map_bf16(&tm_out, out, 2, dims_o, (uint64_t)W * 6, 0, 64);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  ln_hat_kernel<<<(M + 7) / 8, 256, 0, st>>>((const bf16*)x, (bf16*)xhat, M, C);
  const int tiles = (M + BM - 1) / BM * (3 * Wp / BN);
  const int sms = hopper::sm_count();
  const int grid = sms > 0 && sms < tiles ? sms : tiles;
  ln_qkv_rope_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      tm_xhat, tm_w, tm_out, (const float*)gb, (const float*)ca,
      (const float*)sa, (const float*)cb, (const float*)sb, M, N, C, W, use_rope);
  return (int)cudaGetLastError();
}

}  // namespace

// W = C for the whole layer; C / m for one rank's heads.
extern "C" int ln_qkv_rope_launch(const void* x, const void* w, const void* gb,
                                  const void* ca, const void* sa, const void* cb,
                                  const void* sb, void* xhat, void* out, int M, int N,
                                  int C, int W, int use_rope, void* stream) {
  return launch(x, w, gb, ca, sa, cb, sb, xhat, out, M, N, C, W, use_rope, stream);
}
