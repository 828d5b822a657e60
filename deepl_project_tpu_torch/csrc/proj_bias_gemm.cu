// proj_bias_gemm: out = bf16(o @ Wp^T + bp), fp32 accumulation and fp32 bias.
//
// Replaces the output projection inside the TPU kernel
// deepl_project_tpu/ops/pallas/fused_attention_block.py:248 (_forward; the
// head-group accumulation into acc_ref in _kernel and the bias add in _emit
// :132).
//
// o [M, K] bf16, w [Nout, K] bf16 (nn.Linear layout), bias [Nout] fp32,
// out [M, Nout] bf16, all contiguous; K % 64 == 0 and Nout % 128 == 0. M
// need not be a multiple of the tile: TMA fills rows past M with zeros and
// the epilogue does not store them.
//
// Bound on an H100: at large@256 b32 the stage-3 and stage-4 products are
// 2*M*C*C = 38.7 GFLOP over 0.05-0.1 GB, so the tensor cores bound it
// (0.039 ms at 989 TFLOP/s); only wgmma reaches that rate. Design: a
// persistent, warp-specialised wgmma GEMM. One CTA per SM walks the 256 x 128
// output tiles (row-block major, so the CTAs in flight share each row block
// of o and the whole weight through L2). A producer warpgroup gives back its
// registers and one of its threads keeps a 4-stage ring of 64-deep A and B
// tiles full with TMA loads (128-byte swizzle), each stage tracked by a full
// and an empty mbarrier. Two consumer warpgroups of 128 rows each run
// m64n128k16 wgmma on the ring (both operands K-major, straight from shared
// memory), keep one group of products in flight, and free a stage as soon as
// the products that read it have completed. The epilogue adds the fp32 bias
// to the fp32 accumulators, rounds once to bf16 (as _emit does), writes each
// 64-row half into a swizzled staging tile (conflict-free) and hands it to a
// TMA store, which clips rows past M and runs on while the warpgroup starts
// the next tile; the producer is already loading that tile meanwhile.
#include "hopper_tma_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int BM = 256;  // rows of a tile: two consumer warpgroups of 128
constexpr int BN = 128;  // columns of a tile
constexpr int BK = 64;   // depth of a stage (one 128-byte swizzled row)
constexpr int STAGES = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = BM * BK * 2;  // 32 KB
constexpr int kBBytes = BN * BK * 2;  // 16 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBytes = 64 * BN * 2;  // 16 KB: a consumer's 64-row half, two 64-column boxes
constexpr int kSmemBytes = STAGES * kStageBytes + kConsumers * kOutBytes + 2 * STAGES * 8 + 1024;

__global__ __launch_bounds__(kThreads, 1) void proj_bias_gemm_kernel(
    __grid_constant__ const CUtensorMap tm_a, __grid_constant__ const CUtensorMap tm_w,
    __grid_constant__ const CUtensorMap tm_out, const float* __restrict__ bias, int M,
    int K, int Nout) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* staging = smem + STAGES * kStageBytes;  // kOutBytes a consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kConsumers * kOutBytes);
  uint64_t* empty = full + STAGES;

  // Warpgroup index, warp-uniform to the compiler (a shuffle of lane 0's).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tiles_n = Nout / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int KT = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warpgroup.
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
          tma_load_2d(st, &tm_a, &full[s], kt * BK, m0);
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
    // halves sharing the B tile.
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gid = lane / 4, tig = lane % 4;
    float acc[2][64];
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[s], ph);
        const unsigned char* st = smem + s * kStageBytes;
        const uint64_t da = desc_kmajor(st + wg * 128 * 128);
        const uint64_t db = desc_kmajor(st + kABytes);
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
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive_if(&empty[prev], tid == 0);

      // Epilogue, one 64-row half at a time through this warpgroup's staging
      // tile: [2 boxes of 64 columns][64 rows][128 bytes], 16-byte chunk c
      // of row r at chunk c ^ (r % 8) (the store map's 128-byte swizzle).
      unsigned char* stg = staging + wg * kOutBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tid == 0) bulk_wait_read<0>();  // the last store has read stg
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + n0 + j * 8 + tig * 2));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + half * 8 + gid;  // r % 8 == gid
            *reinterpret_cast<uint32_t*>(stg + (j / 8) * 8192 + r * 128 +
                                         (((j % 8) ^ gid) << 4) + tig * 4) =
                pack_bf16(acc[h][4 * j + 2 * half] + b2.x, acc[h][4 * j + 2 * half + 1] + b2.y);
          }
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (tid == 0) {
          const int r0 = m0 + wg * 128 + h * 64;
          tma_store_2d(&tm_out, stg, n0, r0);
          tma_store_2d(&tm_out, stg + 8192, n0 + 64, r0);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait<0>();  // the stores are done before the CTA exits
  }
}

}  // namespace

extern "C" int proj_bias_gemm_launch(const void* a, const void* w,
                                     const void* bias, void* out, int M, int K,
                                     int Nout, void* stream) {
  static bool smem_ok = false;
  if (!smem_ok) {
    cudaError_t e = cudaFuncSetAttribute(
        proj_bias_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  // Maps are encoded on every call: the operands' addresses change.
  CUtensorMap tm_a, tm_w, tm_out;
  const cuuint64_t dims_a[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dims_w[2] = {(cuuint64_t)K, (cuuint64_t)Nout};
  const cuuint64_t dims_o[2] = {(cuuint64_t)Nout, (cuuint64_t)M};
  int e = hopper::make_map_bf16(&tm_a, a, 2, dims_a, (uint64_t)K * 2, 0, BM);
  if (e == 0) e = hopper::make_map_bf16(&tm_w, w, 2, dims_w, (uint64_t)K * 2, 0, BN);
  if (e == 0) e = hopper::make_map_bf16(&tm_out, out, 2, dims_o, (uint64_t)Nout * 2, 0, 64);
  if (e != 0) return e;
  const int tiles = (M + BM - 1) / BM * (Nout / BN);
  const int sms = hopper::sm_count();
  const int grid = sms > 0 && sms < tiles ? sms : tiles;
  proj_bias_gemm_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tm_a, tm_w, tm_out, (const float*)bias, M, K, Nout);
  return (int)cudaGetLastError();
}
