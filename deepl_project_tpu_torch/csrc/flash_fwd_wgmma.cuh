// The attention forward shared by flash_attention_fwd.cu and
// attention_core.cu: non-causal o = softmax(q k^T * scale) v per head,
// head_dim 64, bf16 in, fp32 scores and softmax, bf16 out, and optionally the
// per-row logsumexp (natural log, fp32).
//
// Rounding points (the TPU _flash_kernel's): fp32 scores; online row max and
// row sum; the unnormalised p = exp(s - m) rounded to bf16 for P.V with fp32
// accumulation; one division by the row sum at the end; lse = m + log(l).
//
// q, k, v: [B, N] rows, each tensor with its own row stride (elements), head
// h at columns h*64..; o: [B*N, ld_o]; lse: [B, H, N] fp32. N % 64 == 0.
//
// Bound on an H100: 4 * B*H * N^2 * 64 operations against 4 * B*H*N*64 * 2
// bytes, so the tensor cores bound every shape the port runs. At head_dim 64
// the exponentials weigh as much as the products: a 64 x 128 tile of scores
// is 2 MFLOP of S and P.V (~512 tensor-core clocks of an SM) and 8,192
// exponentials (512 clocks of the SM's 16 SFU lanes), so one warpgroup's
// softmax has to run under another's products.
//
// Design (warp-specialised, wgmma + TMA): a CTA takes 64 * kConsumers query
// rows of one (image, head): kConsumers consumer warpgroups of 64 rows and a
// producer warpgroup that gives its registers to them (setmaxnreg). One
// producer thread loads the q tiles once and streams kBKV-key tiles of k and
// v through a kStages ring with TMA (128-byte swizzle; a full and an empty
// mbarrier a stage), so every K/V tile is read from L2 once per CTA, not once
// per warp. The maps are 3D (columns, N, B): a tile never reads another
// image's rows, rows past N read zeros, and q/k/v may be column slices of
// one [B, N, 3C] buffer with no copy. Each consumer computes S = Q K^T with
// SS-wgmma (both K-major), the online softmax in registers (SFU ex2.approx,
// row max and sum from quad shuffles; each thread keeps its share of the row
// sum, reduced once at the end), packs the unnormalised p to bf16 in place
// (the accumulator layout is wgmma's register A-operand layout) and adds P V
// with the register-A wgmma, v read MN-major. Tile t's S product is issued
// together with tile t-1's P.V, and the softmax of tile t runs while P.V is
// still on the tensor cores. The epilogue divides by l, rounds to bf16 and
// stores through a swizzled staging tile (the warpgroup's q tile, free by
// then) and one TMA store, which clips rows past N; lse is written once per
// row.
//
// Two shapes of CTA, picked by the loop length (measured in turns on an
// H100, PERF.md): for N > kShortN, three consumers (192 queries) share each
// K/V tile, one CTA an SM; for N <= kShortN (attention_core's sublayers, two
// to eight key tiles), one consumer a CTA and two CTAs an SM, so one CTA's
// prologue, epilogue and softmax run under the other's products.
//
// Tails: with 128-key tiles and N % 128 == 64 the last tile's upper 64 keys
// are TMA zero fill, whose scores would be 0 rather than -inf: they are set
// to -inf before the row max. A last query tile past N computes on zero rows
// and its rows are clipped by the store (lse is written only for rows < N).
#pragma once

#include <type_traits>

#include "hopper_tma_wgmma.cuh"

namespace flash {

using namespace hopper;

constexpr int kHD = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One CTA shape: consumer warpgroups, CTAs an SM, keys a ring stage (64 or
// 128), ring depth.
template <int kConsumers_, int kCTAs_, int kBKV_, int kStages_>
struct Tile {
  static constexpr int kConsumers = kConsumers_, kCTAs = kCTAs_;
  static constexpr int kBKV = kBKV_, kStages = kStages_;
  static_assert(kBKV == 64 || kBKV == 128, "64- or 128-key tiles");
  static constexpr int kBQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // setmaxnreg moves registers within the CTA's launch allocation (the
  // per-thread count __launch_bounds__ allows, a multiple of 8, times
  // kThreads); asking the consumers for more than the producer frees would
  // block them for good. E.g. three consumers: 128 x 512 = 24 x 128 + 160 x 384.
  static constexpr int kLaunchRegs = (65536 / (kCTAs * kThreads)) / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kRegsRaw =
      ((kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * kConsumers)) / 8 * 8;
  static constexpr int kConsumerRegs = kRegsRaw < 240 ? kRegsRaw : 240;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    kLaunchRegs * kThreads, "register budget");
  static constexpr int kTileQ = 64 * kHD * 2;     // 8 KB: 64 rows of 128 bytes
  static constexpr int kTileKV = kBKV * kHD * 2;  // a k (or v) tile
  static constexpr int kSmemBytes =
      kConsumers * kTileQ + kStages * 2 * kTileKV + (2 * kStages + 1) * 8 + 1024;
  static constexpr int kS = kBKV / 2;    // score accumulators a thread
  static constexpr int kKC = kBKV / 16;  // k slices of P.V
};

constexpr int kShortN = 1024;
using LongTile = Tile<3, 1, 128, 3>;   // N > kShortN
using ShortTile = Tile<1, 2, 128, 3>;  // N <= kShortN

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

// One k16 slice of S = Q K^T over the tile's keys (64 or 128: the size of d).
template <int N>
__device__ __forceinline__ void s_product(float (&d)[N], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n128k16_ss(d, da, db, scale_d);
  else
    wgmma_m64n64k16_ss(d, da, db, scale_d);
}

template <class C, bool kLSE>
__global__ __launch_bounds__(C::kThreads, C::kCTAs) void fwd_kernel(
    __grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, __grid_constant__ const CUtensorMap tm_o,
    float* __restrict__ lse, int N, float scale_log2) {
  constexpr int kConsumers = C::kConsumers, kBKV = C::kBKV, kStages = C::kStages;
  constexpr int kTileQ = C::kTileQ, kTileKV = C::kTileKV, kS = C::kS, kKC = C::kKC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sq = smem;                        // kConsumers q tiles
  unsigned char* ring = sq + kConsumers * kTileQ;  // stage s: k tile, then v tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTileKV);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = blockIdx.x * C::kBQ, head = blockIdx.y, img = blockIdx.z;
  const int T = (N + kBKV - 1) / kBKV;  // key tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Warpgroup index, warp-uniform to the compiler (a shuffle of lane 0's).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // Producer warpgroup: one thread issues every load.
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_expect_tx(qbar, kConsumers * kTileQ);
      for (int c = 0; c < kConsumers; ++c)
        tma_load_3d(sq + c * kTileQ, &tm_q, qbar, head * kHD, q0 + c * 64, img);
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < T; ++t) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = ring + s * 2 * kTileKV;
        mbar_arrive_expect_tx(&full[s], 2 * kTileKV);
        tma_load_3d(st, &tm_k, &full[s], head * kHD, t * kBKV, img);
        tma_load_3d(st + kTileKV, &tm_v, &full[s], head * kHD, t * kBKV, img);
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg .. +63. Each thread holds
  // rows gid and gid + 8 of its warp's 16, and of each 8 keys j the two at
  // 8j + 2tig (sc[4j], sc[4j+1] for row gid; sc[4j+2], sc[4j+3] for gid + 8).
  setmaxnreg_inc<C::kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  unsigned char* sqw = sq + wg * kTileQ;
  const uint64_t qd = desc_kmajor(sqw);
  const bool partial = kBKV > 64 && N % kBKV != 0;  // the last tile is half zero fill
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int s = 0, prev = 0;
  uint32_t ph = 0;
  uint32_t pa[kKC][4];  // P of the previous tile, the A operand of its P.V
  float sc[kS];         // this tile's scores, then its p

  auto issue_s = [&]() {
    const uint64_t kd = desc_kmajor(ring + s * 2 * kTileKV);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) s_product(sc, qd + 2 * kk, kd + 2 * kk, kk > 0);
    wgmma_commit();
  };
  // v tile: kBKV keys x 64 dims, dims contiguous; k slice kc is 16 rows (two
  // 1024-byte atoms) on.
  auto issue_pv = [&]() {
    const uint64_t vd = desc_mnmajor(ring + prev * 2 * kTileKV + kTileKV);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) wgmma_m64n64k16_rs_mn(oacc, pa[kc], vd + kc * (2048 >> 4), 1);
    wgmma_commit();
  };
  // Online softmax of the tile's raw scores, in place: p = 2^(s c - m c)
  // (c = scale * log2 e > 0, so the max of s c is c times the max of s).
  // Returns the factors that rescale the older o and l.
  auto softmax = [&](auto masked) -> float2 {
    if constexpr (decltype(masked)::value) {
#pragma unroll
      for (int i = kS / 2; i < kS; ++i) sc[i] = -INFINITY;  // keys 64.. lie past N
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kS / 4; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = ex2((m0 - mx0) * scale_log2), a1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float c0 = mx0 * scale_log2, c1 = mx1 * scale_log2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kS / 4; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -c0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -c0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -c1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -c1));
      rs0 += sc[4 * j] + sc[4 * j + 1];
      rs1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    return make_float2(a0, a1);
  };
  // The A operand of k slice kc (keys 16kc..16kc+15): the unnormalised p in
  // bf16; then the stage moves on.
  auto pack_advance = [&]() {
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      const float* d = sc + 8 * kc;
      pa[kc][0] = pack_bf16(d[0], d[1]);
      pa[kc][1] = pack_bf16(d[2], d[3]);
      pa[kc][2] = pack_bf16(d[4], d[5]);
      pa[kc][3] = pack_bf16(d[6], d[7]);
    }
    prev = s;
    if (++s == kStages) {
      s = 0;
      ph ^= 1;
    }
  };
  // P.V of the previous tile done: its stage is free.
  auto pv_done = [&]() {
    wgmma_wait<0>();
    fence_regs(oacc);
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) fence_regs(pa[kc]);
    mbar_arrive_if(&empty[prev], tid == 0);
  };
  // Tile 0: S alone (o is still zero: nothing to rescale).
  auto first = [&](auto masked) {
    mbar_wait(&full[s], ph);
    issue_s();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(masked);
    pack_advance();
  };
  // Tile t: S_t and P_{t-1} V_{t-1} issued together; softmax_t under P.V.
  auto step = [&](auto masked) {
    mbar_wait(&full[s], ph);
    issue_s();
    issue_pv();
    wgmma_wait<1>();
    fence_regs(sc);
    const float2 a = softmax(masked);
    pv_done();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      oacc[4 * j] *= a.x;
      oacc[4 * j + 1] *= a.x;
      oacc[4 * j + 2] *= a.y;
      oacc[4 * j + 3] *= a.y;
    }
    pack_advance();
  };

  mbar_wait(qbar, 0);
  if (T == 1 && partial) first(std::true_type{}); else first(std::false_type{});
  for (int t = 1; t + 1 < T; ++t) step(std::false_type{});
  if (T > 1) {
    if (partial) step(std::true_type{}); else step(std::false_type{});
  }
  issue_pv();  // the last tile's P.V
  pv_done();

  // Epilogue: o / l in bf16 into this warpgroup's q tile (every S product
  // that read it is done) as the store map's swizzle lays it out: 16-byte
  // chunk j of row r at j ^ (r % 8), conflict-free; one TMA store.
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = h ? inv1 : inv0;
      const int r = warp * 16 + h * 8 + gid;  // r % 8 == gid
      *reinterpret_cast<uint32_t*>(sqw + r * 128 + ((j ^ gid) << 4) + tig * 4) =
          pack_bf16(oacc[4 * j + 2 * h] * inv, oacc[4 * j + 2 * h + 1] * inv);
    }
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);
  if (tid == 0) {
    tma_store_3d(&tm_o, sqw, head * kHD, q0 + wg * 64, img);
    bulk_commit();
  }
  if constexpr (kLSE) {
    // m is a raw score: lse = (m c + log2 l) * ln 2 = m * scale + log l.
    const int r0 = q0 + wg * 64 + warp * 16 + gid;
    float* row = lse + ((size_t)img * gridDim.y + head) * N;
    if (tig == 0 && r0 < N) row[r0] = (m0 * scale_log2 + log2f(l0)) * kLn2;
    if (tig == 0 && r0 + 8 < N) row[r0 + 8] = (m1 * scale_log2 + log2f(l1)) * kLn2;
  }
  if (tid == 0) bulk_wait<0>();  // the store is done before the CTA exits
}

// Launch fwd_kernel<C, kLSE> on a (ceil(N / kBQ), H, B) grid; 0 or a CUDA
// error. Internal linkage: the static flag of an inline function would be one
// symbol shared by every library loaded in the process (a build of another
// checkout, timed beside this one, would skip its own attribute).
template <class C, bool kLSE>
static int tile_launch(const CUtensorMap (&maps)[4], float* lse, int B, int N, int H,
                       float scale, cudaStream_t stream) {
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = cudaFuncSetAttribute(fwd_kernel<C, kLSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  dim3 grid((N + C::kBQ - 1) / C::kBQ, H, B);
  fwd_kernel<C, kLSE><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, N, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <bool kLSE>
static int fwd_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int N, int H, int ld_q, int ld_k, int ld_v, int ld_o,
                      float scale, void* stream) {
  const bool short_n = N <= kShortN;
  const uint32_t bkv = short_n ? ShortTile::kBKV : LongTile::kBKV;
  // (columns, N, B) maps, one per operand and call (the addresses change):
  // q and o in 64-row boxes, k and v in kBKV-row boxes.
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, o};
  const int lds[4] = {ld_q, ld_k, ld_v, ld_o};
  const uint32_t rows[4] = {64, bkv, bkv, 64};
  const cuuint64_t dims[3] = {(cuuint64_t)H * kHD, (cuuint64_t)N, (cuuint64_t)B};
  for (int i = 0; i < 4; ++i) {
    const int e = make_map_bf16(&maps[i], bases[i], 3, dims, (uint64_t)lds[i] * 2,
                                (uint64_t)lds[i] * 2 * N, rows[i]);
    if (e != 0) return e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  return short_n ? tile_launch<ShortTile, kLSE>(maps, lse, B, N, H, scale, st)
                 : tile_launch<LongTile, kLSE>(maps, lse, B, N, H, scale, st);
}

}  // namespace flash
