// flash_attention_fwd: o = softmax(q k^T * scale) v per head and the row
// logsumexp, head_dim 64, bf16 in and out, lse fp32 (natural log).
//
// Replaces the TPU kernel
// deepl_project_tpu/ops/pallas/flash_attention.py::_flash_kernel
// (_flash_forward, the forward of flash_attention's custom VJP): fp32
// scores, unnormalised p rounded to bf16 for P.V, division by the row sum at
// the end, lse = m + log(l).
//
// q, k, v: [B*N, ld_*] rows, each tensor with its own row stride (training
// feeds three separate tensors; serving, column slices of one [B*N, 3C]
// buffer), head h at columns h*64..; read in place by TMA, with no
// fold/transpose copies. o: [B*N, ld_o]; lse: [B, H, N]. N % 64 == 0.
//
// Bound on an H100: at the training shape (8 images, 6 heads, N=4096) it does
// 4*BH*N^2*64 = 206 GFLOP against 0.1 GB moved, so the tensor cores bound it
// (0.21 ms). The tile code is flash_fwd_wgmma.cuh (warp-specialised wgmma +
// TMA), shared with attention_core.cu; here it also writes the logsumexp,
// once per row, from the running max and sum.
#include "flash_fwd_wgmma.cuh"

extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int N, int H, int ld_q,
                                          int ld_k, int ld_v, int ld_o,
                                          float scale, void* stream) {
  return flash::fwd_launch<true>(q, k, v, o, (float*)lse, B, N, H, ld_q, ld_k,
                                 ld_v, ld_o, scale, stream);
}
