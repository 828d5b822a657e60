// Shared pieces of the port's Hopper kernels: bf16 mma.sync m16n8k16 with
// fp32 accumulation, ldmatrix fragment loads, cp.async copies, and the
// 128x128x32 GEMM main loop used by ln_qkv_rope.cu and proj_bias_gemm.cu.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), with gid = lane / 4 and
// tig = lane % 4:
//   A (16x16, row-major): a0 = (gid, 2tig..+1)   a1 = (gid+8, 2tig..+1)
//                         a2 = (gid, 2tig+8..+9) a3 = (gid+8, 2tig+8..+9)
//   B (16x8, "col"):      b0 = (k 2tig..+1, n gid) b1 = (k 2tig+8..+9, n gid)
//   C/D (16x8 fp32):      c0,c1 = (gid, 2tig..+1) c2,c3 = (gid+8, 2tig..+1)
// One ldmatrix.x4 fills an A fragment, or the B fragments of two n-tiles,
// from K-contiguous shared memory ([rows][K] for A, [cols][K] for B -- the
// [out, in] layout of an nn.Linear weight).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j,
// and every thread receives (row gid, columns 2tig..+1) of each matrix --
// or, with .trans, (rows 2tig..+1, column gid).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// 16-byte global->shared copy; src_bytes 0 fills zeros (rows past the end).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

namespace tile {

constexpr int BM = 128;      // rows of the output tile
constexpr int BN = 128;      // columns of the output tile
constexpr int BK = 32;       // depth of one pipeline stage
constexpr int LDS = BK + 8;  // padded row (80 B): conflict-free ldmatrix
constexpr int STAGES = 4;    // cp.async pipeline depth
constexpr int THREADS = 256; // 8 warps as 4 (rows) x 2 (cols), 32x64 each

struct Smem {
  bf16 a[STAGES][BM][LDS];
  bf16 b[STAGES][BN][LDS];
};
constexpr int kSmemBytes = sizeof(Smem);  // 80 KB: two CTAs per SM

// Per-row LayerNorm prologue applied to A in shared memory: with kLN, each
// element becomes bf16(float(bf16((x - mean) * rstd)) * g[k] + beta[k]), the
// cast order of the JAX package's plain composition (x-hat rounded to the
// compute dtype before the per-branch affine).
template <bool kLN>
struct APrologue {
  const float* mean;  // [BM] in shared memory
  const float* rstd;  // [BM]
  const float* g;     // [K] affine of this column tile's branch
  const float* beta;  // [K]
};

// acc[mt][nt][i] holds the warp's 32x64 tile: rows wm*32 + mt*16 + gid (+8),
// columns wn*64 + nt*8 + 2tig (+1). Rows >= M read zeros and are never
// stored by the callers. K % BK == 0.
template <bool kLN>
__device__ __forceinline__ void gemm_mainloop(
    Smem& sm, const bf16* __restrict__ A, int lda, const bf16* __restrict__ W,
    int K, int M, int row0, int col0, const APrologue<kLN>& pro,
    float acc[2][8][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // Each thread copies two 16-byte vectors of A and two of B per stage; with
  // kLN it later rewrites its own two A vectors in place.
  auto issue = [&](int kt) {
    const int s = kt % STAGES;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * THREADS, r = id >> 2, cv = id & 3;
      const int k = kt * BK + cv * 8, row = row0 + r;
      cp_async16(&sm.a[s][r][cv * 8], A + (size_t)(row < M ? row : 0) * lda + k,
                 row < M ? 16 : 0);
      cp_async16(&sm.b[s][r][cv * 8], W + (size_t)(col0 + r) * K + k, 16);
    }
  };

  const int KT = K / BK;
  __syncthreads();  // a previous call's readers are done with every stage
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt landed
    if constexpr (kLN) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int id = tid + i * THREADS, r = id >> 2, cv = id & 3;
        const int k = kt * BK + cv * 8;
        uint4* p = reinterpret_cast<uint4*>(&sm.a[s][r][cv * 8]);
        uint4 va = *p;
        bf16* e = reinterpret_cast<bf16*>(&va);
        const float mu = pro.mean[r], rs = pro.rstd[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = round_bf16((__bfloat162float(e[j]) - mu) * rs);
          e[j] = __float2bfloat16(xh * __ldg(pro.g + k + j) + __ldg(pro.beta + k + j));
        }
        *p = va;
      }
    }
    // Tile kt is visible to all; every warp is done with tile kt-1, whose
    // stage the next copy refills.
    __syncthreads();
    if (kt + STAGES - 1 < KT) issue(kt + STAGES - 1);
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], &sm.a[s][wm * 32 + mt * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // b0, b1 of n-tile 2np, then of 2np+1
        ldmatrix_x4(b, &sm.b[s][wn * 64 + np * 16 + (lane & 7) + (lane >> 4) * 8]
                             [ks * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

}  // namespace tile
