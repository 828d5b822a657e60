// small_attention: o = softmax(q k^T * scale) v per head for N <= 1024,
// head_dim 64, bf16 in and out, with the softmax weights normalised and then
// rounded to bf16 before P.V.
//
// Replaces the TPU kernel deepl_project_tpu/ops/pallas/small_attention.py:50
// (_forward; _kernel :27): one program per (image, head) holds the whole fp32
// [N, N] score block (4 MB at N=1024) in VMEM, takes the exact row max and
// sum, forms p = exp(s - m) / l, rounds p to bf16 (:36) and multiplies by v
// with fp32 accumulation.
//
// The rounding point is what sets it apart from the flash kernels, which
// round the *unnormalised* p and divide o at the end: here p is divided first
// and then rounded. An SM's 227 KB of shared memory cannot hold a head's 4 MB
// of scores, so the kernel runs two passes over the keys per query tile and
// keeps nothing of the scores between them:
//   pass 1: s = q k^T tile by tile; the running row max m and the row sum l
//           of exp(s - m), rescaled as m grows (exact up to fp32 rounding);
//   pass 2: s again, p = exp2(s * c - m * c) * (1 / l) rounded to bf16
//           (c = scale * log2 e, folded into one FFMA), o += p v.
//
// Bound on an H100: at 512px stage 4 (8 images, 24 heads, N=1024) the
// function needs 4*B*h*N^2*64 = 51.5 GFLOP against 0.1 GB moved, so the
// tensor cores bound it (0.052 ms); pass 1's recomputed q k^T adds half again
// to the products (0.078 ms at peak), and the two exponentials a score take
// ~0.1 ms of the SFU's 16 a clock per SM unless they overlap the products.
//
// Design (warp-specialised, wgmma + TMA): a CTA takes 64 query rows of one
// (image, head) with one consumer warpgroup and one producer warp. The
// producer loads the q tile once, then streams 64-key tiles -- k alone for
// pass 1, k and v for pass 2 -- through a two-stage ring with TMA (128-byte
// swizzle), one full and one empty mbarrier a stage. The maps are 3D
// (columns, N, B), so a tile never reads another image's keys. The consumer
// computes S = Q K^T with m64n64k16 wgmma from shared memory (both K-major),
// turns the accumulators into P in registers (the accumulator layout is
// wgmma's register A-operand layout), and adds P V with the register-A
// m64n64k16 wgmma, v read MN-major (transpose flag). Exponentials are the
// SFU's ex2.approx.ftz. Each warpgroup runs its products and exponentials in
// turn; the overlap comes from four CTAs on each SM (90 registers and 41 KB
// of shared memory each), which measured faster than keeping products in
// flight within a warpgroup (ptxas then serialises the wgmmas for register
// resources), than 128-key tiles, and than more warpgroups a CTA.
//
// q, k, v: [B, N] rows, each with its own row stride (elements), head h at
// columns h*64..; o: [B*N, ld_o]. N % 64 == 0.
#include "hopper_tma_wgmma.cuh"

namespace small {

using namespace hopper;

constexpr int kHD = 64;
constexpr int kBQ = 64;   // query rows a CTA: one consumer warpgroup
constexpr int kBKV = 64;  // keys a tile
constexpr int kStages = 2;
constexpr int kThreads = 128 + 32;     // + one producer warp
constexpr int kTile = kBKV * kHD * 2;  // 8 KB: one 64 x 64 bf16 tile
constexpr int kSmemBytes = kTile + kStages * 2 * kTile + (2 * kStages + 1) * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (MUFU.EX2; subnormal results flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ __launch_bounds__(kThreads, 4) void small_attention_kernel(
    __grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, bf16* __restrict__ o, int N, int ld_o,
    float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sq = smem;           // the q tile
  unsigned char* ring = smem + kTile;  // stage s: k tile, then v tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, img = blockIdx.z;
  const int T = N / kBKV;  // key tiles a pass

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Warp index, warp-uniform to the compiler (a shuffle of lane 0's).
  if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 4) {
    // Producer warp: lane 0 issues every load.
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(qbar, kTile);
      tma_load_3d(sq, &tm_q, qbar, head * kHD, q0, img);
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < 2 * T; ++t) {
        const int kt = t < T ? t : t - T;
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = ring + s * 2 * kTile;
        mbar_arrive_expect_tx(&full[s], t < T ? kTile : 2 * kTile);
        tma_load_3d(st, &tm_k, &full[s], head * kHD, kt * kBKV, img);
        if (t >= T) tma_load_3d(st + kTile, &tm_v, &full[s], head * kHD, kt * kBKV, img);
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup: each thread holds rows gid and gid + 8 of its warp's
  // 16, and of each 8 keys j the two at 8j + 2tig (d[4j], d[4j+1] for row
  // gid; d[4j+2], d[4j+3] for row gid + 8).
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const uint64_t dq = desc_kmajor(sq);
  float sacc[32], oacc[32];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int s = 0;
  uint32_t ph = 0;

  // S = Q K^T of the k tile in the next stage, once it is full; awaited.
  auto scores = [&]() {
    mbar_wait(&full[s], ph);
    const uint64_t dk = desc_kmajor(ring + s * 2 * kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk)
      wgmma_m64n64k16_ss(sacc, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
  };
  auto release = [&]() {
    mbar_arrive_if(&empty[s], tid == 0);
    if (++s == kStages) {
      s = 0;
      ph ^= 1;
    }
  };

  // Pass 1: row max of the raw scores (c > 0, so max(s * c) = c * max(s))
  // and this thread's share of the row sum, rescaled as the max grows.
  mbar_wait(qbar, 0);
  for (int t = 0; t < T; ++t) {
    scores();
    release();
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = mx0 * scale_log2, c1 = mx1 * scale_log2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      rs0 += ex2(fmaf(sacc[4 * j], scale_log2, -c0)) +
             ex2(fmaf(sacc[4 * j + 1], scale_log2, -c0));
      rs1 += ex2(fmaf(sacc[4 * j + 2], scale_log2, -c1)) +
             ex2(fmaf(sacc[4 * j + 3], scale_log2, -c1));
    }
    l0 = l0 * ex2((m0 - mx0) * scale_log2) + rs0;
    l1 = l1 * ex2((m1 - mx1) * scale_log2) + rs1;
    m0 = mx0;
    m1 = mx1;
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const float mc0 = m0 * scale_log2, mc1 = m1 * scale_log2;

  // Pass 2: the normalised weights, rounded to bf16, times v.
  for (int t = 0; t < T; ++t) {
    scores();
    uint32_t pa[4][4];  // A operand of k slice kc: keys 16kc..16kc+15
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const float* d = sacc + 8 * kc;
      pa[kc][0] = pack_bf16(ex2(fmaf(d[0], scale_log2, -mc0)) * inv0,
                            ex2(fmaf(d[1], scale_log2, -mc0)) * inv0);
      pa[kc][1] = pack_bf16(ex2(fmaf(d[2], scale_log2, -mc1)) * inv1,
                            ex2(fmaf(d[3], scale_log2, -mc1)) * inv1);
      pa[kc][2] = pack_bf16(ex2(fmaf(d[4], scale_log2, -mc0)) * inv0,
                            ex2(fmaf(d[5], scale_log2, -mc0)) * inv0);
      pa[kc][3] = pack_bf16(ex2(fmaf(d[6], scale_log2, -mc1)) * inv1,
                            ex2(fmaf(d[7], scale_log2, -mc1)) * inv1);
    }
    // v tile: 64 keys x 64 dims, dims contiguous; k slice kc is 16 rows (two
    // 1024-byte atoms) on.
    const uint64_t dv = desc_mnmajor(ring + s * 2 * kTile + kTile);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_m64n64k16_rs_mn(oacc, pa[kc], dv + kc * (2048 >> 4), t > 0 || kc > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_regs(pa[kc]);
    release();
  }

  const int r0 = q0 + warp * 16 + gid;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* orow = o + ((size_t)img * N + r0 + half * 8) * ld_o + head * kHD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<bf162*>(orow + j * 8 + tig * 2) =
          __floats2bfloat162_rn(oacc[4 * j + half * 2], oacc[4 * j + half * 2 + 1]);
  }
}

}  // namespace small

extern "C" int small_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int N, int H, int ld_q,
                                      int ld_k, int ld_v, int ld_o, float scale,
                                      void* stream) {
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = cudaFuncSetAttribute(small::small_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         small::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  // (columns, N, B) maps, one per operand and call (the addresses change):
  // a tile past an image's last row reads zeros, never the next image.
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int lds[3] = {ld_q, ld_k, ld_v};
  const cuuint64_t dims[3] = {(cuuint64_t)H * 64, (cuuint64_t)N, (cuuint64_t)B};
  for (int i = 0; i < 3; ++i) {
    const int e = hopper::make_map_bf16(&maps[i], bases[i], 3, dims, (uint64_t)lds[i] * 2,
                                        (uint64_t)lds[i] * 2 * N, 64);
    if (e != 0) return e;
  }
  dim3 grid(N / small::kBQ, H, B);
  small::small_attention_kernel<<<grid, small::kThreads, small::kSmemBytes,
                                  (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], (bf16*)o, N, ld_o, scale * small::kLog2e);
  return (int)cudaGetLastError();
}
