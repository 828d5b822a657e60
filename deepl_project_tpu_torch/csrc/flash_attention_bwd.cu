// flash_attention_bwd: dq, dk and dv of o = softmax(q k^T * scale) v in one
// pass, head_dim 64, bf16 in and out.
//
// Replaces the TPU kernels deepl_project_tpu/ops/pallas/flash_attention.py:115
// (_flash_bwd_dq_kernel, launched at :196) and :145 (_flash_bwd_dkv_kernel,
// launched at :218), both from _flash_backward (:181), at their rounding
// points: p = exp(q k^T * scale - lse) in fp32; dv += bf16(p)^T dO;
// dp = dO v^T in fp32; ds = p * (dp - delta) * scale in fp32;
// dk += bf16(ds)^T q and dq += bf16(ds) k; every sum in fp32, one bf16
// rounding at the end. delta = rowsum(dO * o) in fp32 (XLA's work beside
// the TPU kernels) comes from a small kernel ahead of the pass.
//
// Bound on an H100 at the training shape (8 images x 6 heads, N = 4096): the
// function needs five products, 10 * BH * N^2 * 64 = 515 GFLOP (0.52 ms at
// 989 TFLOP/s), against ~0.1 GB of operands, so the tensor cores bound it;
// its BH * N^2 = 805 M exponentials take ~0.21 ms of the SFU (16 a clock per
// SM). The TPU split runs seven products (S and dP in both kernels, 0.73 ms)
// and takes every exponential twice.
//
// Design (warp-specialised, wgmma + TMA, FA2/FA3 order): one CTA owns 128
// keys of one (image, head): two consumer warpgroups of 64 keys and a
// producer warpgroup that gives its registers to them (setmaxnreg). The key
// tile is the fastest grid index, so the CTAs of one (image, head) run
// together and share its q/dO rows and dq sums in L2. K and V arrive once by
// TMA (128-byte swizzle) and stay resident; the producer streams 64-query
// tiles of q and dO, with their lse and delta slices, through a 4-stage ring
// (a full and an empty mbarrier a stage). Per query tile each consumer
// computes S^T = K q^T and dP^T = V dO^T with wgmma from shared memory (both
// K-major), taking the exponentials of P^T while dP^T is still in flight.
// P^T and dS^T come out of the accumulators in the register A-operand
// layout, so dV += bf16(P^T) dO and dK += bf16(dS^T) q run with A from
// registers and B MN-major; dK and dV stay in registers for the whole loop,
// and each exponential is taken once. bf16(dS^T) is also written into a
// 128-byte-swizzled shared tile (conflict-free; two tiles, for alternate
// query tiles), and after a barrier of the two consumers each computes 32 of
// the query tile's 64 dq columns over all 128 keys, dQ = dS K, both operands
// read MN-major from shared memory (a transposed-A wgmma). Query tiles go in
// groups of four: a tile's dV/dK and dQ products are awaited in the next
// tile of its group, behind that tile's S^T and dP^T, and only then is its
// stage freed and its partial dq sent, while those products run. The group's
// last tile awaits everything: products left in flight across the loop's
// back edge made ptxas serialise the wgmmas for registers (C7512). The
// partial dq goes through a swizzled fp32 staging tile into one TMA
// reduce-add into an fp32 [B, H, N, 64] buffer in L2 (N/128 partial sums a
// value, 1.6 GB of reductions a call at the training shape; measured faster
// than vector atomics from the registers). A small kernel ahead of the pass
// computes delta and zeroes the buffer, one after it rounds the buffer to
// bf16 dq. dK and dV leave through swizzled staging tiles and TMA stores.
//
// Determinism: in flash_attention_bwd_launch the N/128 partial sums of each
// dq value reach L2 in an order that changes from run to run, so dq's fp32
// sum differs between runs in its last bits, and its bf16 rounding can then
// differ by one step; dk and dv are deterministic. The TPU kernels are
// deterministic, and so is flash_attention_bwd_det_launch (the wrapper takes
// it when torch.are_deterministic_algorithms_enabled()): there each 128-key
// CTA stores its partial dq with a plain TMA store into its own slot of an
// fp32 [B, H, ceil(N/128), N, 64] buffer (every slot row written once, so
// nothing is zeroed), and the rounding kernel adds the slots in ascending
// key order before it rounds. The buffer grows as N^2 (1.5 GiB at the
// training shape) and costs its write and read in device memory.
//
// q, o, dO: [B, Nq] rows and k, v: [B, Nk] rows (a ring step's queries and
// the visiting key chunk; any lengths >= 1), each with its own row stride
// (elements), head h at columns h*64..; lse: [B, H, Lq] fp32 with
// Lq = Nq rounded up to 64 (entries past Nq unread); scratch delta
// [B, H, Lq] and dq_acc [B, H, Lq, 64] fp32 ([B, H, ceil(Nk/128), Lq, 64]
// deterministic); dq: [B*Nq, ld_out], dk, dv: [B*Nk, ld_out] bf16.
// Maps are 3D (columns, rows, B) over Nq or Nk rows: a tile never reads
// another image's rows, and rows past a length read zeros. The length
// bounds: where Nq or Nk is no multiple of 64 (the kernel's kMask form), in
// a CTA whose keys pass Nk, or a query tile that passes Nq, P and dS are
// set to zero at every key >= Nk and every query >= Nq, so padded keys get
// zero dK and dV and padded queries add nothing; the TMA
// stores clip dK/dV rows past Nk and the rounding kernel writes dq rows
// below Nq only.
#include <type_traits>

#include "hopper_tma_wgmma.cuh"

namespace fbwd {

using namespace hopper;

constexpr int kHD = 64;
constexpr int kBQ = 64;   // queries a ring stage
constexpr int kBK = 128;  // keys a CTA: two consumer warpgroups of 64
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTile = 64 * kHD * 2;  // 8 KB: 64 rows of 128 bytes
constexpr int kKV = kBK * kHD * 2;   // 16 KB: the CTA's K (or V)
constexpr int kDS = kBK * kBQ * 2;   // 16 KB: bf16 dS^T, 128 keys x 64 queries
constexpr int kRow = kBQ * 4;        // 256 bytes: a stage's lse (or delta)
constexpr int kDQ = kBQ * 32 * 4;  // 8 KB: a consumer's fp32 dq, 64 queries x 32 columns
constexpr int kSmemBytes = 2 * kKV + 2 * kDS + kConsumers * 2 * kDQ +
                           kStages * (2 * kTile + 2 * kRow) + (2 * kStages + 1) * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (MUFU.EX2; subnormal results flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kDet: each CTA's partial dq goes to its own slot (a TMA store) instead of
// a reduce-add into the shared sum. kMask: Nq or Nk is no multiple of 64,
// so the tail tiles mask P and dS element by element; without it (every
// length a multiple of 64) only the empty half of a final 64-key tile is
// masked, a warpgroup at a time, and the pass is the unbounded one.
template <bool kDet, bool kMask>
__global__ __launch_bounds__(kThreads, 1) void flash_bwd_kernel(
    __grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, __grid_constant__ const CUtensorMap tm_g,
    __grid_constant__ const CUtensorMap tm_dk, __grid_constant__ const CUtensorMap tm_dv,
    __grid_constant__ const CUtensorMap tm_dq, const float* __restrict__ lse,
    const float* __restrict__ delta, int Nq, int Nk, int Lq, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sk = smem;            // K: keys 0..63 (consumer 0), 64..127 (consumer 1)
  unsigned char* sv = sk + kKV;        // V, the same
  unsigned char* sds = sv + kKV;       // two dS^T tiles (alternate query tiles)
  unsigned char* sdq = sds + 2 * kDS;  // two fp32 dq staging tiles a consumer
  unsigned char* ring = sdq + kConsumers * 2 * kDQ;  // stage s: q tile, then dO tile
  float* rows = reinterpret_cast<float*>(ring + kStages * 2 * kTile);  // stage s: lse, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + kStages * 2 * kBQ);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int k0 = blockIdx.x * kBK, head = blockIdx.y, img = blockIdx.z;
  const size_t bh = (size_t)img * gridDim.y + head;
  const int T = (Nq + kBQ - 1) / kBQ;  // query tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Warpgroup index, warp-uniform to the compiler (a shuffle of lane 0's).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // Producer warpgroup: one thread issues every load.
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_expect_tx(kvbar, 2 * kKV);
      for (int i = 0; i < 2; ++i) {
        tma_load_3d(sk + i * kTile, &tm_k, kvbar, head * kHD, k0 + i * 64, img);
        tma_load_3d(sv + i * kTile, &tm_v, kvbar, head * kHD, k0 + i * 64, img);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < T; ++t) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = ring + s * 2 * kTile;
        float* rs = rows + s * 2 * kBQ;
        mbar_arrive_expect_tx(&full[s], 2 * kTile + 2 * kRow);
        tma_load_3d(st, &tm_q, &full[s], head * kHD, t * kBQ, img);
        tma_load_3d(st + kTile, &tm_g, &full[s], head * kHD, t * kBQ, img);
        bulk_load(rs, lse + bh * Lq + t * kBQ, kRow, &full[s]);
        bulk_load(rs + kBQ, delta + bh * Lq + t * kBQ, kRow, &full[s]);
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: keys k0 + 64 wg .. +63. Each thread holds key
  // rows gid and gid + 8 of its warp's 16, and of each 8 queries j the two
  // at 8j + 2tig (d[4j], d[4j+1] for row gid; d[4j+2], d[4j+3] for gid + 8).
  setmaxnreg_inc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const bool live = k0 + wg * 64 < Nk;  // false: the empty half of a final 64-key tile
  const bool key_tail = k0 + kBK > Nk;  // this CTA holds keys at or past Nk
  const int key_row = k0 + wg * 64 + warp * 16 + gid;  // the key of st[4j], st[4j+1]
  const float scale_log2 = scale * kLog2e;
  const uint64_t ka = desc_kmajor(sk + wg * kTile);  // A of S^T: this warpgroup's keys
  const uint64_t va = desc_kmajor(sv + wg * kTile);  // A of dP^T
  // B of dQ = dS K: all 128 keys (k slice kc 2048 bytes on), this
  // warpgroup's 32 of the 64 columns (64 bytes into each row).
  const uint64_t kb = desc_mnmajor(sk) + ((wg * 64) >> 4);
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kvbar, 0);

  float dqa[16];  // dq of the previous query tile, in flight into the next
  // The partial dq of query tile t (query rows warp*16 + gid (+8), columns
  // 32 wg + 8j + 2tig (+1)) added into dq_acc by one TMA reduction, through
  // this consumer's two alternating staging tiles: 64 rows of 32 fp32 (128
  // bytes), 16-byte chunk c of row r at c ^ (r % 8), conflict-free writes.
  auto reduce_dq = [&](int t) {
    unsigned char* stg = sdq + (wg * 2 + (t & 1)) * kDQ;
    if (tid == 0) bulk_wait_read<1>();  // the reduction two tiles back has read stg
    named_bar_sync(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + h * 8 + gid;  // r % 8 == gid
        *reinterpret_cast<float2*>(stg + r * 128 + (((2 * j + (tig >> 1)) ^ gid) << 4) +
                                   (tig & 1) * 8) =
            make_float2(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    if (tid == 0) {
      if constexpr (kDet)
        tma_store_2d(&tm_dq, stg, wg * 32, (int)((bh * gridDim.x + blockIdx.x) * Lq + t * kBQ));
      else
        tma_reduce_add_2d(&tm_dq, stg, wg * 32, (int)(bh * Lq + t * kBQ));
      bulk_commit();
    }
  };
  uint32_t pa[4][4], da[4][4];  // A operands of dV and dK, in flight into the next tile
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i / 4][i % 4] = da[i / 4][i % 4] = 0u;
  int s = 0, prev = 0;
  uint32_t ph = 0;
  // Query tile t; `after` (std::true_type) when tile t-1's dV/dK and dQ
  // products are still in flight.
  auto tile = [&](int t, auto after) {
    mbar_wait(&full[s], ph);
    unsigned char* sq = ring + s * 2 * kTile;
    unsigned char* sg = sq + kTile;
    const float* slse = rows + s * 2 * kBQ;
    const float* sdelta = slse + kBQ;

    // S^T = K q^T and dP^T = V dO^T (64 keys x 64 queries), two groups.
    float st[32], dpt[32];
    const uint64_t qb = desc_kmajor(sq), gb = desc_kmajor(sg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) wgmma_m64n64k16_ss(st, ka + 2 * kk, qb + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) wgmma_m64n64k16_ss(dpt, va + 2 * kk, gb + 2 * kk, kk > 0);
    wgmma_commit();

    // The previous tile's dV/dK and dQ products are done (only S^T and dP^T
    // are younger): free its stage and send its dq while these two run. No
    // fence_regs(dqa) is needed: the reductions are memory operations, which
    // the wait's memory clobber keeps after it.
    if constexpr (decltype(after)::value) {
      wgmma_wait<2>();
      mbar_arrive_if(&empty[prev], tid == 0);
      reduce_dq(t - 1);
    }

    // P^T = exp(S^T * scale - lse) while dP^T is in flight.
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(slse + 8 * j + 2 * tig);
      const float c0 = l.x * kLog2e, c1 = l.y * kLog2e;
      st[4 * j] = ex2(fmaf(st[4 * j], scale_log2, -c0));
      st[4 * j + 1] = ex2(fmaf(st[4 * j + 1], scale_log2, -c1));
      st[4 * j + 2] = ex2(fmaf(st[4 * j + 2], scale_log2, -c0));
      st[4 * j + 3] = ex2(fmaf(st[4 * j + 3], scale_log2, -c1));
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      fence_regs(pa[kc]);
      fence_regs(da[kc]);
    }
    // dS^T = P^T * (dP^T - delta) * scale; both zero at keys >= Nk and
    // queries >= Nq (selected, so the unread lse and delta past Nq never
    // reach them).
    if (kMask && (key_tail || (t + 1) * kBQ > Nq)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(sdelta + 8 * j + 2 * tig);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = key_row + ((i & 2) ? 8 : 0) < Nk &&
                          t * kBQ + 8 * j + 2 * tig + (i & 1) < Nq;
          const float p = in ? st[4 * j + i] : 0.f;
          dpt[4 * j + i] = in ? p * (dpt[4 * j + i] - ((i & 1) ? dl.y : dl.x)) * scale : 0.f;
          st[4 * j + i] = p;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(sdelta + 8 * j + 2 * tig);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = (kMask || live) ? st[4 * j + i] : 0.f;
          dpt[4 * j + i] = p * (dpt[4 * j + i] - ((i & 1) ? dl.y : dl.x)) * scale;
          st[4 * j + i] = p;
        }
      }
    }
    // A operands of k slice kc (queries 16kc..16kc+15), rounded to bf16.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kc][i] = pack_bf16(st[8 * kc + 2 * i], st[8 * kc + 2 * i + 1]);
        da[kc][i] = pack_bf16(dpt[8 * kc + 2 * i], dpt[8 * kc + 2 * i + 1]);
      }
    }
    // bf16(dS^T) into this query tile's shared tile: key row r (this
    // warpgroup's half), 16-byte chunk j of queries at j ^ (r % 8). The
    // tile was last read by tile t-2's dQ products, which both consumers
    // awaited before the barrier of tile t-1.
    unsigned char* dsb = sds + (t & 1) * kDS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + h * 8 + gid;  // r % 8 == gid
        *reinterpret_cast<uint32_t*>(dsb + r * 128 + ((j ^ gid) << 4) + tig * 4) =
            da[j >> 1][(j & 1) * 2 + h];
      }
    }
    fence_proxy_async();

    // dV += P^T dO and dK += dS^T q: A from registers, B (16 queries x 64
    // dims a k slice, two atoms) MN-major.
    const uint64_t gm = desc_mnmajor(sg), qm = desc_mnmajor(sq);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_m64n64k16_rs_mn(dva, pa[kc], gm + kc * (2048 >> 4), 1);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_m64n64k16_rs_mn(dka, da[kc], qm + kc * (2048 >> 4), 1);
    wgmma_commit();

    // dQ[:, 32 wg..] = dS K over the 128 keys, once both halves of dS^T are
    // written. dS^T's rows are keys and its columns queries: A MN-major.
    // Awaited in the next tile of the group, or by drain().
    named_bar_sync(1, 128 * kConsumers);
    const uint64_t dsa = desc_mnmajor(dsb);
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      wgmma_m64n32k16_ss_tt(dqa, dsa + kc * (2048 >> 4), kb + kc * (2048 >> 4), kc > 0);
    wgmma_commit();
    prev = s;
    if (++s == kStages) {
      s = 0;
      ph ^= 1;
    }
  };
  // Everything in flight done: free the last stage and send the last dq.
  auto drain = [&](int t) {
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(dqa);
    mbar_arrive_if(&empty[prev], tid == 0);
    reduce_dq(t);
  };
  // Groups of four tiles, then the rest one by one.
  int t = 0;
  for (; t + 3 < T; t += 4) {
    tile(t, std::false_type{});
    tile(t + 1, std::true_type{});
    tile(t + 2, std::true_type{});
    tile(t + 3, std::true_type{});
    drain(t + 3);
  }
  for (; t < T; ++t) {
    tile(t, std::false_type{});
    drain(t);
  }

  // Epilogue: dK and dV of this warpgroup's 64 keys through a swizzled
  // staging tile each (the dS^T tiles, once both consumers are done with
  // them) and TMA stores, which clip rows past Nk.
  named_bar_sync(1, 128 * kConsumers);
  unsigned char* stg = sds + wg * kDS;  // dK tile, then dV tile
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (warp * 16 + h * 8 + gid) * 128 + ((j ^ gid) << 4) + tig * 4;
      *reinterpret_cast<uint32_t*>(stg + off) = pack_bf16(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(stg + kTile + off) =
          pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
  fence_proxy_async();
  named_bar_sync(2 + wg, 128);
  if (tid == 0) {
    tma_store_3d(&tm_dk, stg, head * kHD, k0 + wg * 64, img);
    tma_store_3d(&tm_dv, stg + kTile, head * kHD, k0 + wg * 64, img);
    bulk_commit();
    bulk_wait<0>();  // the stores are done before the CTA exits
  }
}

// Before the pass: delta[b, h, n] = sum of dO * o over the row (fp32
// products and sum, as XLA computes it beside the TPU kernels) and, if
// kZero, dq_acc[b, h, n, :] = 0, for n < N (row stride L); eight threads a
// row, 8 values each.
template <bool kZero>
__global__ void dq_prepare_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                                  float* __restrict__ delta, float* __restrict__ dq_acc,
                                  int N, int L, int H, int ld_o, int ld_g, size_t groups) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  // Every lane of a warp reaches the shuffles (groups % 8 == 0, but not
  // always % 32); a lane past the end loads and stores nothing.
  const bool in = i < groups;
  const int c8 = (int)(i % 8);
  const size_t row = i / 8;  // (b, n, h), the inputs' order
  const int h = (int)(row % H);
  const int n = (int)(row / H % N);
  const size_t b = row / H / N;
  float sum = 0.f;
  if (in) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + (b * N + n) * ld_o + h * kHD + c8 * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + (b * N + n) * ld_g + h * kHD + c8 * 8);
    const bf162* op = reinterpret_cast<const bf162*>(&ov);
    const bf162* gp = reinterpret_cast<const bf162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(op[e]), c = __bfloat1622float2(gp[e]);
      sum = fmaf(a.x, c.x, sum);
      sum = fmaf(a.y, c.y, sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (!in) return;
  const size_t out = (b * H + h) * L + n;
  if (c8 == 0) delta[out] = sum;
  if constexpr (kZero) {
    float4* z = reinterpret_cast<float4*>(dq_acc + out * kHD + c8 * 8);
    z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// After it: dq[b, n, h, :] = bf16 of dq_acc[b, h, n, :] (slots = 1), or of
// the sum of dq_acc[b, h, x, n, :] over the slots x in ascending order (the
// deterministic form), for n < N (row stride L); one thread per 8 values.
__global__ void dq_convert_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, int N,
                                  int L, int H, int slots, int ld_out, size_t groups) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const int c8 = (int)(i % 8);
  const size_t row = i / 8;  // (b, h, n)
  const int n = (int)(row % N);
  const int h = (int)(row / N % H);
  const size_t b = row / N / H;
  const size_t bh = row / N;
  const float4* src = reinterpret_cast<const float4*>(acc + (bh * slots * L + n) * kHD + c8 * 8);
  const size_t step = (size_t)L * kHD / 4;  // one slot on, in float4
  float4 a = src[0], c = src[1];
  for (int x = 1; x < slots; ++x) {
    const float4 a2 = src[x * step], c2 = src[x * step + 1];
    a.x += a2.x; a.y += a2.y; a.z += a2.z; a.w += a2.w;
    c.x += c2.x; c.y += c2.y; c.z += c2.z; c.w += c2.w;
  }
  uint4 out;
  out.x = pack_bf16(a.x, a.y);
  out.y = pack_bf16(a.z, a.w);
  out.z = pack_bf16(c.x, c.y);
  out.w = pack_bf16(c.z, c.w);
  *reinterpret_cast<uint4*>(dq + (b * N + n) * ld_out + h * kHD + c8 * 8) = out;
}

// The three kernels of a backward call; 0 or a CUDA error. Internal linkage,
// as flash_fwd_wgmma.cuh's fwd_launch, so that its static flag is this
// library's own.
template <bool kDet>
static int bwd_launch(const void* q, const void* k, const void* v, const void* o,
                      const void* g, const void* lse, void* delta, void* dq_acc, void* dq,
                      void* dk, void* dv, int B, int Nq, int Nk, int H, int ld_q, int ld_k,
                      int ld_v, int ld_o, int ld_g, int ld_out, float scale, void* stream) {
  if (Nq < 1 || Nk < 1) return (int)cudaErrorInvalidValue;
  const int Lq = (Nq + kBQ - 1) / kBQ * kBQ;  // row stride of lse, delta and dq_acc
  const bool mask = Nq % kBQ != 0 || Nk % 64 != 0;
  static bool smem_ok[2] = {false, false};
  if (!smem_ok[mask]) {
    cudaError_t e = cudaFuncSetAttribute(
        mask ? flash_bwd_kernel<kDet, true> : flash_bwd_kernel<kDet, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_ok[mask] = true;
  }
  // (columns, rows, B) maps, one per operand and call (the addresses
  // change): q and dO over Nq rows, k, v, dk and dv over Nk rows.
  CUtensorMap maps[6];
  const void* bases[6] = {q, k, v, g, dk, dv};
  const int lds[6] = {ld_q, ld_k, ld_v, ld_g, ld_out, ld_out};
  const int ns[6] = {Nq, Nk, Nk, Nq, Nk, Nk};
  for (int i = 0; i < 6; ++i) {
    const cuuint64_t dims[3] = {(cuuint64_t)H * 64, (cuuint64_t)ns[i], (cuuint64_t)B};
    const int e = hopper::make_map_bf16(&maps[i], bases[i], 3, dims, (uint64_t)lds[i] * 2,
                                        (uint64_t)lds[i] * 2 * ns[i], 64);
    if (e != 0) return e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const size_t groups = (size_t)B * H * Nq * 8;
  const unsigned blocks = (unsigned)((groups + 255) / 256);
  dq_prepare_kernel<!kDet><<<blocks, 256, 0, st>>>((const bf16*)o, (const bf16*)g,
                                                   (float*)delta, (float*)dq_acc, Nq, Lq, H,
                                                   ld_o, ld_g, groups);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Nk + kBK - 1) / kBK, H, B);
  // dq_acc as [B*H*slots*Lq, 64] fp32 rows (one slot, or one a key tile),
  // reduced into or stored to by 32-column boxes.
  const int slots = kDet ? (int)grid.x : 1;
  CUtensorMap tm_dq;
  int me = hopper::make_map_f32_2d(&tm_dq, dq_acc, 64, (uint64_t)B * H * slots * Lq, 32, 64);
  if (me != 0) return me;
  (mask ? flash_bwd_kernel<kDet, true> : flash_bwd_kernel<kDet, false>)
      <<<grid, kThreads, kSmemBytes, st>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                           maps[5], tm_dq, (const float*)lse,
                                           (const float*)delta, Nq, Nk, Lq, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_convert_kernel<<<blocks, 256, 0, st>>>((const float*)dq_acc, (bf16*)dq, Nq, Lq, H, slots,
                                            ld_out, groups);
  return (int)cudaGetLastError();
}

}  // namespace fbwd

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const void* lse, void* delta, void* dq_acc, void* dq, void* dk, void* dv, int B, int Nq,
    int Nk, int H, int ld_q, int ld_k, int ld_v, int ld_o, int ld_g, int ld_out, float scale,
    void* stream) {
  return fbwd::bwd_launch<false>(q, k, v, o, g, lse, delta, dq_acc, dq, dk, dv, B, Nq, Nk, H,
                                 ld_q, ld_k, ld_v, ld_o, ld_g, ld_out, scale, stream);
}

// The same arguments; dq_acc is the fp32 [B, H, ceil(Nk/128), Lq, 64] slot buffer.
extern "C" int flash_attention_bwd_det_launch(
    const void* q, const void* k, const void* v, const void* o, const void* g,
    const void* lse, void* delta, void* dq_acc, void* dq, void* dk, void* dv, int B, int Nq,
    int Nk, int H, int ld_q, int ld_k, int ld_v, int ld_o, int ld_g, int ld_out, float scale,
    void* stream) {
  return fbwd::bwd_launch<true>(q, k, v, o, g, lse, delta, dq_acc, dq, dk, dv, B, Nq, Nk, H,
                                ld_q, ld_k, ld_v, ld_o, ld_g, ld_out, scale, stream);
}
