"""Switch-style Mixture-of-Experts FFN on one device (PyTorch port of
``ops/moe.py``).

Top-1 routing by an fp32 router; each image's tokens fill a fixed capacity
per expert, ``ceil(N * capacity_factor / E)``, in token order (a cumsum over
the image's tokens), and a token past it contributes 0 (the caller's
residual carries it). Dispatch and combine are einsums against a one-hot
[B, N, E, C] tensor in the activation dtype; the experts run as one batched
product over a leading expert axis. The load-balance loss ``E * sum(f_e *
p_e)`` (f the share of tokens routed to e, p the mean router probability)
is kept on the module by each forward, where :func:`collect_aux_losses`
takes it: the counterpart of the JAX module's sown 'losses' collection.

``expert_axis`` is carried for the config and inert here: expert
parallelism waits for the port's parallelism slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


class ExpertLinear(nn.Module):
    """E independent linears: ``weight`` [E, out, in], ``bias`` [E, out]
    (the JAX vmapped Dense's [E, in, out] kernel transposed per expert); x
    [E, ..., in] -> [E, ..., out] in x's dtype."""

    def __init__(self, num_experts: int, d_in: int, d_out: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_experts, d_out, d_in, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_experts, d_out, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e, d_in = x.shape[0], x.shape[-1]
        w = self.weight.to(x.dtype)
        flat = x.reshape(e, -1, d_in)
        out = torch.baddbmm(self.bias.to(x.dtype)[:, None], flat, w.transpose(1, 2))
        return out.reshape(*x.shape[:-1], w.shape[1])


class _Experts(nn.Module):
    """One dense FFN per expert: SwiGLU (gate, up, down) or the GELU MLP
    (up, down)."""

    def __init__(self, num_experts: int, d: int, hidden: int, use_swiglu: bool, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.use_swiglu = use_swiglu
        if use_swiglu:
            self.gate = ExpertLinear(num_experts, d, hidden, **kw)
        self.up = ExpertLinear(num_experts, d, hidden, **kw)
        self.down = ExpertLinear(num_experts, hidden, d, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.use_swiglu:
            h = F.silu(self.gate(h)) * self.up(h)
        else:
            h = F.gelu(self.up(h), approximate="tanh")
        return self.down(h)


class SwitchFFN(nn.Module):
    """Top-1 MoE FFN on [B, N, D] tokens; the same in/out shape as a dense
    FFN (the caller adds the residual)."""

    def __init__(self, d: int, hidden: int, num_experts: int, capacity_factor: float = 1.25,
                 use_swiglu: bool = True, expert_axis: str | None = "expert", *,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.expert_axis = expert_axis
        self.router = Linear(d, num_experts, device=device, dtype=torch.float32)
        self.experts = _Experts(num_experts, d, hidden, use_swiglu, device=device,
                                dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        e = self.num_experts
        cap = max(1, math.ceil(n * self.capacity_factor / e))

        # Router in fp32 (Switch Transformer section 2.4).
        probs = torch.softmax(self.router(x.float()), dim=-1)          # [B, N, E]
        gate = probs.amax(dim=-1)                                      # [B, N]
        onehot = F.one_hot(probs.argmax(dim=-1), e).float()            # [B, N, E]

        # Each token's slot in its expert's buffer; past capacity, no slot.
        pos = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1.0        # [B, N]
        keep = (pos < cap).float()
        pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)).float()  # [B, N, C]
        dispatch = (onehot * keep[..., None])[..., None] * pos_oh[:, :, None]
        combine = dispatch * gate[..., None, None]                     # [B, N, E, C]

        self.aux_loss = e * (onehot.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()

        xin = torch.einsum("bnec,bnd->ebcd", dispatch.to(x.dtype), x)
        xout = self.experts(xin)                                       # [E, B, C, D]
        return torch.einsum("bnec,ebcd->bnd", combine.to(x.dtype), xout)


def collect_aux_losses(model: nn.Module) -> torch.Tensor:
    """The sum (fp32) of the load-balance losses the model's SwitchFFN layers
    kept in their last forward, taken off them (so a graph is not held past
    its step); 0 when it has none."""
    total = torch.zeros((), dtype=torch.float32)
    for m in model.modules():
        aux = m.__dict__.pop("aux_loss", None) if isinstance(m, SwitchFFN) else None
        if aux is not None:
            total = total.to(aux.device) + aux.float()
    return total
