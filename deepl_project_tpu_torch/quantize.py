"""Int8 post-training quantization of a TransVAE: calibrate, then transform
(PyTorch port of ``quantize.py``).

    qmodel = quantize_model(model, calib_batches, scope="resblock")
    recon, mu, logvar = qmodel(x)          # same call as the float model

``calib_batches`` is an iterable of [B, H, W, 3] images in [0, 1] (numpy or
tensors, NHWC as the JAX package and the serving engine take them); a
handful is enough, the activation scales being per-tensor absmax. The
calibration pass runs the float model with its ResBlocks and ConvFFNs
recording each quantization site's absmax; the transform builds the int8
model (``config.replace(quant='int8', quant_scope=scope)``) on the float
model's device: per-output-channel int8 kernels and static activation
scales for every ResBlock (scope 'all' or 'resblock') and full ConvFFN
(scope 'all' or 'ffn'), the folded FFN matrices quantized directly (one
quantization step, no rounding of the fold in between). Everything else
(attention, norms, stem, resample convs, latent heads) keeps its float
parameters.

Inference only; requires ``conv_ffn_type='full'`` (every variant).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .models.transvae import TransVAE
from .ops.blocks import ResBlock
from .ops.ffn import ConvFFN
from .ops.quant import QMAX, quantize_weight
from .utils.convert import load_state_dict

SCOPES = ("all", "resblock", "ffn")


def _sites(model):
    """(name, module) of every module with calibration sites."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, (ResBlock, ConvFFN))]


@torch.no_grad()
def calibrate_amax(model: TransVAE, calib_batches: Iterable) -> dict:
    """Run the float model over the batches; returns {module name: {site:
    absmax (fp32 scalar tensor)}}, the running maximum over all batches."""
    device = next(model.parameters()).device
    sites = _sites(model)
    for _, m in sites:
        m.calibrate, m.amax = True, {}
    n = 0
    try:
        for x in calib_batches:
            x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
            model(x.permute(0, 3, 1, 2), sample=False)
            n += 1
    finally:
        for _, m in sites:
            m.calibrate = False
    if n == 0:
        raise ValueError("quantize: calib_batches is empty")
    return {name: {k: v.cpu() for k, v in m.amax.items()} for name, m in sites if m.amax}


def _act_scale(amax: torch.Tensor) -> torch.Tensor:
    return amax.float().clamp_min(1e-8) / QMAX


def _q_conv(sd: dict, prefix: str, weight, bias, amax) -> None:
    """An OIHW conv (or [out, in] dense) weight as int8 buffers."""
    wq, ws = quantize_weight(weight, axis=0)
    if wq.dim() == 4:
        wq = wq.permute(0, 2, 3, 1).contiguous()  # [out, kh, kw, in]
    sd.update({f"{prefix}.kernel_q": wq, f"{prefix}.kernel_scale": ws,
               f"{prefix}.act_scale": _act_scale(amax), f"{prefix}.bias": bias.float()})
    sd.pop(f"{prefix}.weight")


def quantize_state_dict(model: TransVAE, amax: dict, scope: str = "all") -> dict:
    """The float model's state_dict rewritten into the ``quant='int8'``
    model's: ResBlocks (scope 'all'/'resblock') and full ConvFFNs
    ('all'/'ffn') quantized with the calibrated ``amax``."""
    sd = dict(model.state_dict())
    for name, m in _sites(model):
        if isinstance(m, ResBlock) and scope in ("all", "resblock"):
            for sub, site in (("conv1", "amax_h1"), ("conv2", "amax_h2"), ("shortcut", "amax_x")):
                conv = getattr(m, sub)
                if conv is not None:
                    _q_conv(sd, f"{name}.{sub}", conv.weight, conv.bias, amax[name][site])
        elif isinstance(m, ConvFFN) and m.quant is None and scope in ("all", "ffn"):
            if not isinstance(m.conv, torch.nn.Sequential):
                continue
            am = amax[name]
            conv0, conv2 = m.conv[0], m.conv[4]
            ch, hidden = conv0.weight.shape[:2]
            # The folded matrices of the fold_output float path, in fp32.
            wout = m.proj_out.weight.float().t()  # [hidden, dim]
            w_head = torch.cat([conv0.weight.float().reshape(ch, hidden).t(), wout], 1)
            w_fold = conv2.weight.float().reshape(hidden, ch).t() @ wout  # [ch, dim]
            b_fold = conv2.bias.float() @ wout + m.proj_out.bias.float()
            wh_q, wh_s = quantize_weight(w_head, axis=-1)
            wf_q, wf_s = quantize_weight(w_fold, axis=-1)
            _q_conv(sd, f"{name}.proj_in", m.proj_in.weight, m.proj_in.bias, am["amax_in"])
            _q_conv(sd, f"{name}.conv.2", m.conv[2].weight, m.conv[2].bias, am["amax_z"])
            for key in ("conv.0.weight", "conv.0.bias", "conv.4.weight", "conv.4.bias",
                        "proj_out.weight", "proj_out.bias"):
                sd.pop(f"{name}.{key}")
            sd.update({f"{name}.w_head_q": wh_q.t().contiguous(),
                       f"{name}.w_head_scale": wh_s,
                       f"{name}.act_scale_y": _act_scale(am["amax_y"]),
                       f"{name}.b0": conv0.bias.float(),
                       f"{name}.w_fold_q": wf_q.t().contiguous(),
                       f"{name}.w_fold_scale": wf_s,
                       f"{name}.act_scale_z2": _act_scale(am["amax_z2"]),
                       f"{name}.b_fold": b_fold.float()})
    return sd


def quantize_model(model: TransVAE, calib_batches: Iterable, scope: str = "all") -> TransVAE:
    """Calibrate ``model`` on ``calib_batches`` and return its int8 twin
    (``quant='int8'``, ``quant_scope=scope``) on the same device, in eval
    mode."""
    cfg = model.config
    if cfg.scan_blocks:
        raise ValueError("quant='int8' does not support scan_blocks param "
                         "layouts; rebuild the checkpoint with "
                         "scan_blocks=False (ops/stack.py converters).")
    if cfg.conv_ffn_type != "full":
        raise ValueError("quant='int8' requires conv_ffn_type='full'")
    if scope not in SCOPES:
        raise ValueError(f"quant scope must be all|resblock|ffn, got {scope}")
    amax = calibrate_amax(model, calib_batches)
    sd = quantize_state_dict(model, amax, scope)
    device = next(model.parameters()).device
    with torch.device("meta"):
        qmodel = TransVAE(cfg.replace(quant="int8", quant_scope=scope, quant_calibrate=False))
    qmodel = qmodel.to_empty(device=device)
    load_state_dict(qmodel, sd)
    return qmodel.eval()
