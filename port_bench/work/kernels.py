"""Operations and bytes of the hand-written kernels, from the shapes that
each launch passes, and the card's peaks they are held to.

The arithmetic is the port's ``chip_smoke.py`` (``flash_bound``, ``bound``)
copied here and widened to the shapes the launchers take (a query length
and a key length of their own; a rank's head width W beside C): every
product the algorithm needs (2 operations a multiply-add), each input byte
read once and each output byte written once, whatever a kernel reads again
or keeps in scratch. A launcher's integer arguments are read by position
(``ARGS``); the pointers and the stream are skipped.

The bound of a call is max(operations / peak, bytes / 3.35 TB/s): 989
TFLOP/s for the bfloat16 tensor-core kernels, 67 TFLOP/s (float32 outside
the tensor cores) for GroupNorm -> SiLU, which its bytes bound in any case.
"""

from __future__ import annotations

import re

BF16_PEAK = 989e12
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
HEAD_DIM = 64

# launcher -> (position of its first integer argument, their names): the
# launchers' C signatures (pointers first, then the integers).
ARGS = {
    "ln_qkv_rope": (9, ("m", "n", "c", "w", "use_rope")),
    "attention_core": (4, ("b", "n", "h", "ld", "c")),
    "proj_bias_gemm": (4, ("m", "k", "c")),
    "flash_attention_fwd": (5, ("b", "n", "nk", "h")),
    "flash_attention_bwd": (11, ("b", "n", "nk", "h")),
    "flash_attention_bwd_det": (11, ("b", "n", "nk", "h")),
    "small_attention": (4, ("b", "n", "h")),
    "group_norm_stats": (2, ("code", "b", "hw", "c")),
    "group_norm_apply": (6, ("code", "b", "hw", "c")),
}

# The device kernels the launchers start (``csrc/*.cu``, ``*.cuh``): the
# names a trace shows for them.
KERNEL_NAMES = re.compile(
    r"\b(fwd_kernel|flash_bwd_kernel|dq_prepare_kernel|dq_convert_kernel|stats_kernel|"
    r"apply_kernel|ln_hat_kernel|ln_qkv_rope_kernel|proj_bias_gemm_kernel|"
    r"small_attention_kernel)\b")


def ints(name: str, args: tuple) -> dict:
    """The launch's integer arguments by name (``ARGS[name]``)."""
    first, names = ARGS[name]
    return dict(zip(names, (int(x) for x in args[first:first + len(names)])))


def work(name: str, a: dict) -> tuple[float, float, float]:
    """(operations, bytes, peak operations/s) of one launch."""
    if name == "ln_qkv_rope":
        m, n, c, w = a["m"], a["n"], a["c"], a["w"]
        # x read, the [3W, C] weight, LN scales and shifts, four RoPE
        # tables of [N, 32] fp32, q | k | v written.
        return (2 * m * c * 3 * w,
                m * c * 2 + 3 * w * c * 2 + 6 * c * 4 + 4 * n * 32 * 4 + 3 * m * w * 2,
                BF16_PEAK)
    if name == "attention_core":
        b, n, c = a["b"], a["n"], a["c"]
        return 4 * b * n * n * c, 4 * b * n * c * 2, BF16_PEAK
    if name == "proj_bias_gemm":
        m, k, c = a["m"], a["k"], a["c"]
        return 2 * m * k * c, m * k * 2 + c * k * 2 + c * 4 + m * c * 2, BF16_PEAK
    if name == "flash_attention_fwd":
        b, n, nk, h = a["b"], a["n"], a["nk"], a["h"]
        q, kv = b * n * h * HEAD_DIM * 2, b * nk * h * HEAD_DIM * 2
        # q, k, v read; o and the fp32 logsumexp rows written.
        return 4 * b * h * n * nk * HEAD_DIM, 2 * q + 2 * kv + b * h * n * 4, BF16_PEAK
    if name in ("flash_attention_bwd", "flash_attention_bwd_det"):
        b, n, nk, h = a["b"], a["n"], a["nk"], a["h"]
        q, kv = b * n * h * HEAD_DIM * 2, b * nk * h * HEAD_DIM * 2
        # Five products (S, dP, dV, dK, dQ); q, o, dO read and dq written,
        # k, v read and dk, dv written, the lse rows read.
        return 10 * b * h * n * nk * HEAD_DIM, 4 * q + 4 * kv + b * h * n * 4, BF16_PEAK
    if name == "small_attention":
        b, n, h = a["b"], a["n"], a["h"]
        return 4 * b * h * n * n * HEAD_DIM, 4 * b * n * h * HEAD_DIM * 2, BF16_PEAK
    if name == "group_norm_stats":
        size = 2 if a["code"] == 1 else 4
        return 3 * a["b"] * a["hw"] * a["c"], a["b"] * a["hw"] * a["c"] * size, FP32_PEAK
    if name == "group_norm_apply":
        size = 2 if a["code"] == 1 else 4
        elems = a["b"] * a["hw"] * a["c"]
        return 6 * elems, 2 * elems * size, FP32_PEAK
    raise KeyError(f"no work formula for launcher {name!r}")


def bound_s(name: str, a: dict) -> float:
    ops, nbytes, peak = work(name, a)
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)
