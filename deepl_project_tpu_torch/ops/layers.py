"""Linear and Conv2d with the JAX package's dtype/param_dtype split, and the
initializers of its modules.

Parameters stay in their own dtype (float32 by default) and are cast to the
compute dtype of the input at each call, as flax's ``dtype``/``param_dtype``
do; the cast is free when the two agree. Under an ambient context group
(``parallel.context``) a Conv2d whose kernel is taller than one row, or
whose stride is more than one, fetches the rows its outputs read from the
ranks that hold them first (``parallel.halo``).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import context as cp
from ..parallel.halo import context_conv2d


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        state = cp.current()
        if state is not None:
            return context_conv2d(self, x, state)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D, or batched 3-D) with fp32 accumulation and an fp32
    result: the JAX package's ``preferred_element_type=float32``. On CUDA a
    bf16 product takes the ``out_dtype`` form; that form has no derivative
    (and no CPU kernel), so a product that autograd records, and any CPU
    product, takes fp32 copies of the operands instead (the same products
    and sums)."""
    tracked = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and a.dtype != torch.float32 and not tracked:
        return (torch.bmm if a.dim() == 3 else torch.mm)(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


# The keep masks dropout() drew since record_dropout_masks() began; None
# outside such a block.
_MASKS: list | None = None


@contextlib.contextmanager
def record_dropout_masks():
    """Collect the keep mask (bool, the input's shape) of every
    :func:`dropout` call in the block, in call order, into the list it
    yields."""
    global _MASKS
    saved, _MASKS = _MASKS, []
    try:
        yield _MASKS
    finally:
        _MASKS = saved


def dropout(x: torch.Tensor, p: float, group=None) -> torch.Tensor:
    """Inverted dropout, the modules' one draw: each entry of ``x`` kept with
    probability 1 - p and scaled by 1 / (1 - p), else 0 (``F.dropout`` in
    training, the JAX package's ``nn.Dropout``).

    The mask is ``torch.rand`` over x's shape from a ``torch.Generator`` on
    x's device, seeded by one int64 drawn from the global CPU generator
    (which ``torch.utils.checkpoint`` restores for a recompute, so a
    recomputed block draws its mask again). ``group``: the model group of a
    placement whose ranks hold x replicated (``parallel.shard_params`` sets
    it on the modules): group rank 0's seed is broadcast over it, 8 bytes a
    call (under NCCL through the device, and read back: one host sync), so
    every rank draws the same mask, the one a single process draws at the
    same global seed and shape."""
    if p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    seed = torch.randint(1 << 62, (1,))
    if group is not None and dist.get_world_size(group) > 1:
        if dist.get_backend(group) == "nccl":
            seed = seed.to(x.device)
        dist.broadcast(seed, dist.get_global_rank(group, 0), group=group)
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    if _MASKS is not None:
        _MASKS.append(keep)
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


# The depth slice that a stage stack's iteration runs (ops.stack), per
# thread; None outside one.
_DEPTH = threading.local()


@contextlib.contextmanager
def depth_slice(j: int):
    """Run the enclosed forward as slice ``j`` of a stage stack: the cached
    operands of its modules are kept per slice."""
    outer = getattr(_DEPTH, "index", None)
    _DEPTH.index = j
    try:
        yield
    finally:
        _DEPTH.index = outer


class CachedOperands:
    """Mixin for modules whose forward reads tensors derived from their
    parameters (cast, packed or folded weights): made once and rebuilt when
    any of the parameters changes (another storage, or an in-place update,
    its ``_version``). A weight that FSDP gathers (``_gathered_from``: new
    storage at each use) is keyed on the slice it was gathered from, so a
    reused allocation never hits a stale operand. A module that a stage
    stack runs on each of its depth slices (ops.stack) keeps one entry a
    slice: the slices are views of one stack, so an in-place update of the
    stack (their shared ``_version``) remakes every slice's."""

    def _cached(self, name, params, make, differentiable: bool = False):
        """``make()`` under no_grad, cached per parameter version. With
        ``differentiable``, a call that autograd records (grad on and a
        parameter requiring it) runs ``make()`` under autograd instead, so
        training differentiates through the derived tensors."""
        if differentiable and torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return make()
        key = tuple((src.data_ptr(), src._version)
                    for src in (getattr(p, "_gathered_from", p) for p in params))
        store = self.__dict__.setdefault("_operand_cache", {})
        slot = (name, getattr(_DEPTH, "index", None))
        hit = store.get(slot)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, make())
            store[slot] = hit
        return hit[1]


class GELU(nn.Module):
    """GELU at the compute precision: the tanh form in bf16 (within bf16's
    own rounding of the erf form), exact erf otherwise -- the JAX package's
    ``_gelu``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


@torch.no_grad()
def init_linear_(m: nn.Linear, generator: torch.Generator | None) -> None:
    """truncated_normal(0.02) (cut at two standard deviations), zero bias."""
    nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def init_conv_(m: nn.Conv2d, generator: torch.Generator | None) -> None:
    """Kaiming normal over fan_out (variance_scaling(2, 'fan_out', 'normal')),
    zero bias."""
    w = m.weight
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_out), generator=generator)
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def init_small_conv_(m: nn.Conv2d, generator: torch.Generator | None,
                     scale: float = 1e-4) -> None:
    """variance_scaling(scale, 'fan_in', 'truncated_normal'), zero bias: the
    latent heads' small-variance init."""
    w = m.weight
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    if m.bias is not None:
        m.bias.zero_()
