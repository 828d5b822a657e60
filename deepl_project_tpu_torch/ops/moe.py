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

Expert parallelism (the JAX module's ``_ep_constraint``): under an ambient
group of the ``expert_axis`` (``parallel.mesh.use_axes``) of size ep, a
module placed by :meth:`SwitchFFN.hold_experts` holds experts [r E/ep, (r +
1) E/ep) and runs them on its slice of the dispatched tokens; the outputs
are all-gathered along E before the combine. The tokens are replicated
over the expert group in every JAX placement, so GSPMD's all-to-all is
that slice and that all-gather: ``gather_from_group``, whose backward takes
this rank's slice (the loss is the same on every rank of the group), and
``copy_to_group`` on the tokens entering the dispatch, whose backward sums
each rank's share of their gradient. Under an ambient ``data`` group the
load-balance loss takes the global batch's f and p (``global_mean``), as
GSPMD computes it. Without an ambient expert group a module holds every
expert, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to_group, gather_from_group, global_mean
from ..parallel.mesh import DATA_AXIS, ambient
from .layers import Linear


class ExpertLinear(nn.Module):
    """E independent linears: ``weight`` [E, out, in], ``bias`` [E, out]
    (the JAX vmapped Dense's [E, in, out] kernel transposed per expert); x
    [E, ..., in] -> [E, ..., out] in x's dtype. Under expert parallelism
    (``SwitchFFN.hold_experts``) experts [first, first + E) of ``total``."""

    first = 0
    total = None

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
                 keep_aux: bool = True, device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.expert_axis = expert_axis
        # False: the load-balance loss is not kept (the DiT's pipelined
        # layout drops it, as JAX's scan layout drops the sown losses).
        self.keep_aux = keep_aux
        self.held = (0, num_experts)  # the experts [lo, hi) this module holds
        self.router = Linear(d, num_experts, device=device, dtype=torch.float32)
        self.experts = _Experts(num_experts, d, hidden, use_swiglu, device=device,
                                dtype=param_dtype)

    def hold_experts(self, rank: int, size: int, axis: int = 0) -> None:
        """Keep only experts [rank E/size, (rank + 1) E/size) of the whole set,
        in place (on the meta device too); ``axis``: the experts' axis of
        the weights (1 in a stack, behind its depth axis)."""
        e = self.num_experts
        if e % size:
            raise ValueError(f"{e} experts do not split over an expert group of {size} ranks")
        lo, hi = rank * e // size, (rank + 1) * e // size
        for lin in self.experts.children():
            lin.first, lin.total = lo, e
            for name in ("weight", "bias"):
                full = getattr(lin, name)
                setattr(lin, name, nn.Parameter(full.detach().narrow(axis, lo, hi - lo).clone(),
                                                requires_grad=full.requires_grad))
        self.held = (lo, hi)

    def _expert_group(self):
        """The ambient expert group (None without one), checked against the
        experts this module holds."""
        state = ambient(self.expert_axis)
        e = self.num_experts
        want = (0, e) if state is None else (state.rank * e // state.size,
                                             (state.rank + 1) * e // state.size)
        if self.held != want:
            who = ("no expert group is ambient, so this rank runs" if state is None
                   else f"rank {state.rank} of the ambient expert group runs")
            raise RuntimeError(
                f"this SwitchFFN holds experts [{self.held[0]}, {self.held[1]}) of {e}; {who} "
                f"experts [{want[0]}, {want[1]}): place it with hold_experts under its group")
        return None if state is None else state.group

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

        if self.keep_aux:
            fp = torch.stack([onehot.mean(dim=(0, 1)), probs.mean(dim=(0, 1))])
            data = ambient(DATA_AXIS)
            if data is not None:
                fp = global_mean(fp, data.group)
            self.aux_loss = e * (fp[0] * fp[1]).sum()

        group = self._expert_group()
        lo, hi = self.held
        xe = x if group is None else copy_to_group(x, group)
        xin = torch.einsum("bnec,bnd->ebcd", dispatch[:, :, lo:hi].to(x.dtype), xe)
        xout = self.experts(xin)                                       # [E_held, B, C, D]
        if group is not None:
            xout = gather_from_group(xout, 0, group)                   # [E, B, C, D]
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
