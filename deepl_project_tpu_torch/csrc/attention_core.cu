// attention_core: non-causal o = softmax(q k^T * scale) v, head_dim 64,
// bf16 in, fp32 scores and softmax, bf16 out.
//
// Replaces the attention inside the TPU kernel
// deepl_project_tpu/ops/pallas/fused_attention_block.py::_forward (_kernel's
// row-chunked exact softmax and P.V per head).
//
// q, k, v: token-major [B*N, ld] with head h at columns h*64 .. h*64+63 (the
// three may be column slices of one [B*N, 3C] buffer); q and k share the
// per-head column permutation of ln_qkv_rope, which a dot product over the
// head does not see. o: [B*N, ld_o], written in v's (unpermuted) layout.
// N % 64 == 0.
//
// Bound on an H100: at large@256 b32 stage 3 (N=1024, 12 heads) it does
// 4*B*h*N^2*64 = 103 GFLOP over 0.2 GB, so the tensor cores bound it
// (0.10 ms). The tile code is flash_fwd_wgmma.cuh (shared with
// flash_attention_fwd.cu), here without the logsumexp output.
//
// Rounding point: P is rounded to bf16 unnormalised and o divided by the row
// sum at the end, as in the flash forward. The TPU sublayer kernel rounds
// the normalised weights (fused_attention_block.py:122-126); doing that here
// needs the row sum before P.V, i.e. a second Q K^T pass (+50% products, as
// small_attention.cu pays), so the port keeps the flash rounding point. The
// two differ by bf16 rounding of the weights only (the card holds the kernel
// to attention_core_reference, which normalises first, within 2^-6 x max).
#include "flash_fwd_wgmma.cuh"

extern "C" int attention_core_launch(const void* q, const void* k,
                                     const void* v, void* o, int B, int N,
                                     int H, int ld, int ld_o, float scale,
                                     void* stream) {
  return flash::fwd_launch<false>(q, k, v, o, nullptr, B, N, H, ld, ld, ld,
                                  ld_o, scale, stream);
}
