"""The training optimizers (PyTorch port of ``training/optim.py``).

``make_optimizer`` builds what the JAX package's optax chain computes,
written out over tensors:

    apply_if_finite(                      # NaN-skip, max_consecutive_errors
      multi_transform(                    # freeze_encoder: encoder -> zeros
        chain(clip_by_global_norm(max_grad_norm),
              adamw(schedule, b1, b2, eps, weight_decay, mu_dtype)
              | adafactor(schedule, min_dim_size_to_factor=128,
                          decay_rate=0.8, momentum=None,
                          multiply_by_parameter_scale=False))))

Shared by both (:class:`_Chain`):

- A step whose gradients hold a non-finite value changes nothing (params,
  moments, counts), unless more than ``max_consecutive_errors`` such steps
  came in a row; ``notfinite_count`` / ``total_notfinite`` count them.
- The clip is optax's: g * max_norm / norm when norm >= max_norm (no 1e-6
  term), over the trainable gradients only.
- ``freeze_encoder``: parameters whose name has an ``encoder`` component get
  zero updates and no state, and stay out of the clip norm.
- The schedule is read at the 0-based count of applied updates.

:class:`AdamW` (``torch._foreach_*``): mu = b1 mu + (1 - b1) g, nu = b2 nu +
(1 - b2) g^2, bias-corrected with the update count, u = mu_hat /
(sqrt(nu_hat) + eps) + wd * p, and the step is -lr(count) * u. With
``mu_dtype='bfloat16'`` mu is stored in bf16 and updated as bf16(b1) * mu +
(1 - b1) * g in fp32, as the compiled optax chain computes it.
``torch.optim.AdamW`` differs in each of these points (epsilon placement
aside, its clip helper adds 1e-6 and it has no NaN-skip), hence the class.

:class:`Adafactor`, optax's rule (``factorized.py``, ``alias.py``): with
decay d = 1 - (count + 1)^-0.8 and g2 = g^2 + 1e-30, a parameter whose two
largest dimensions are >= 128 keeps row and column means of g2 (v_row,
v_col; u = g (v_row / mean(v_row))^-1/2 v_col^-1/2), any other the full v
(u = g v^-1/2); then u / max(1, rms(u)) (``clip_by_block_rms(1.0)``), then
-lr(count) * u. No first moment. The two dimensions are the ones optax
picks on the JAX layout of the parameter (:func:`jax_layout`), mapped to
the port's.

The update is in place on the parameters and on the gradients handed in.

Over sharded parameters (``placement``, a ``parallel.Placement``: FSDP or
tensor parallelism, each rank holding a slice of some parameters and their
gradients; or a ``parallel.PipelinePlacement``: pipeline stages and
experts), as the JAX chain computes on the global arrays: the non-finite
check and the clip's global norm reduce over the placement's groups (the
squares of sharded gradients summed there, replicated ones counted once);
Adafactor picks its factored dimensions on the whole shape and its row,
column and RMS means sum over the model group where the dimension they
reduce is split; ``state_dict`` gathers whole moments and
``load_state_dict`` takes whole moments and keeps this rank's slices.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .schedule import Schedule, warmup_constant

# Tensors per foreach group: bounds the update's temporaries.
_GROUP_NUMEL = 1 << 26
# The JAX make_optimizer's fixed Adafactor settings: optax's decay_rate, its
# eps added to g^2, min_dim_size_to_factor, and clip_by_block_rms's threshold.
_DECAY_RATE = 0.8
_EPS = 1e-30
_MIN_DIM_TO_FACTOR = 128
_BLOCK_RMS = 1.0
# A stack's parameter: a TransVAE stage's or the DiT's (leading depth axis).
_STACKED = re.compile(r"(^|\.)(scan\.block|blocks\.block)\.")


def _is_frozen(name: str) -> bool:
    return "encoder" in name.split(".")


class _Chain:
    """The NaN-skip, freeze partition and global-norm clip around an
    optimizer's rule (``_update``), over named parameters."""

    kind = ""

    def __init__(self, named_params, schedule: Schedule, *, max_grad_norm: float = 1.0,
                 freeze_encoder: bool = False, nan_skip: bool = True,
                 max_consecutive_errors: int = 100, placement=None):
        self.names, self.params = map(list, zip(*named_params))
        # A Placement with sharded parameters, else None (every tensor whole).
        self.placement = placement if placement is not None and placement.sharded else None
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.nan_skip = nan_skip
        self.max_consecutive_errors = max_consecutive_errors
        self.trainable = [not (freeze_encoder and _is_frozen(n)) for n in self.names]
        self.count = 0  # applied updates
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.last_finite = True

    @property
    def trainable_names(self) -> set[str]:
        return {n for n, t in zip(self.names, self.trainable) if t}

    @staticmethod
    def saved_trainable_names(state: dict) -> set[str]:
        """The parameters a saved state trains (it holds state for each)."""
        if state.get("kind", "adamw") == "adafactor":
            return set(state["v"]) | set(state["v_row"])
        return set(state["mu"])

    def trains_as(self, state: dict) -> bool:
        """Whether a saved state is of this optimizer over the same trainable
        parameters (what a structured restore in the JAX trainer needs)."""
        return (state.get("kind", "adamw") == self.kind
                and self.saved_trainable_names(state) == self.trainable_names)

    def _state_dim(self, key: str, name: str) -> int | None:
        """The split dimension of state tensor ``key`` of parameter ``name``."""
        return self.placement.dim(name)

    def state_dict(self) -> dict:
        """The whole state (sharded moments gathered: a collective over the
        model group, called on every rank)."""
        state = self._state()
        if self.placement is not None:
            state = {key: self.placement.full_named(
                named, lambda n, key=key: self._state_dim(key, n))
                for key, named in state.items()}
        return {"kind": self.kind, "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite, "last_finite": self.last_finite,
                **state}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for key in ("count", "notfinite_count", "total_notfinite", "last_finite"):
            setattr(self, key, state[key])
        if self.placement is not None:
            own = self._state()
            state = {key: (self.placement.local_named(
                state[key], list(own[key]), lambda n, key=key: self._state_dim(key, n))
                if key in own else state[key]) for key in state}
        self._load(state)

    def _norm(self, tensors: list[torch.Tensor], idx: list[int]) -> torch.Tensor:
        if self.placement is None:
            return torch.stack(torch._foreach_norm(tensors)).norm()
        return self.placement.norm(tensors, [self.names[i] for i in idx])

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> bool:
        """Apply one update from fp32 ``grads`` (one per parameter, modified
        in place); returns False when the step was skipped as non-finite."""
        finite = True
        if self.nan_skip:
            amax = torch.stack(torch._foreach_norm(grads, float("inf")))
            if self.placement is None:
                finite = bool(torch.isfinite(amax).all())
            else:
                finite = not self.placement.any_peer(~torch.isfinite(amax).all())
        self.last_finite = finite
        if not finite:
            self.notfinite_count += 1
            self.total_notfinite += 1
            if self.notfinite_count <= self.max_consecutive_errors:
                return False
        else:
            self.notfinite_count = 0

        idx = [i for i, t in enumerate(self.trainable) if t]
        g = [grads[i] for i in idx]
        norm = self._norm(g, idx)
        if bool(norm >= self.max_grad_norm):
            torch._foreach_div_(g, norm)
            torch._foreach_mul_(g, self.max_grad_norm)
        self.count += 1
        self._update(idx, grads, self.schedule(self.count - 1))
        return True


class AdamW(_Chain):
    """AdamW with global-norm clipping, NaN-skip and an optional frozen
    encoder over named parameters (see the module docstring)."""

    kind = "adamw"

    def __init__(self, named_params, schedule: Schedule, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: str | None = None, **chain):
        super().__init__(named_params, schedule, **chain)
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.mu_dtype = getattr(torch, mu_dtype) if mu_dtype else None
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) if t else None
                       for p, t in zip(self.params, self.trainable)]
            self.nu = [torch.zeros_like(p) if t else None
                       for p, t in zip(self.params, self.trainable)]

    def _state(self) -> dict:
        return {"mu": {n: m for n, m in zip(self.names, self.mu) if m is not None},
                "nu": {n: v for n, v in zip(self.names, self.nu) if v is not None}}

    def _load(self, state: dict) -> None:
        for name, m, v in zip(self.names, self.mu, self.nu):
            if m is not None:
                m.copy_(state["mu"][name])
                v.copy_(state["nu"][name])

    # -- update ------------------------------------------------------------
    def _groups(self, idx):
        group, numel = [], 0
        for i in idx:
            group.append(i)
            numel += self.params[i].numel()
            if numel >= _GROUP_NUMEL:
                yield group
                group, numel = [], 0
        if group:
            yield group

    def _update(self, idx: list[int], grads: list[torch.Tensor], lr: float) -> None:
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - float(torch.tensor(b1) ** self.count)
        bc2 = 1.0 - float(torch.tensor(b2) ** self.count)
        # JAX multiplies a low-precision moment by b1 taken to the moment's
        # dtype first (a weakly typed constant); in the compiled step XLA
        # keeps that product and the sum in fp32 (excess precision).
        b1_low = float(torch.tensor(b1, dtype=self.mu_dtype or torch.float32))
        for group in self._groups(idx):
            p = [self.params[i] for i in group]
            gr = [grads[i] for i in group]
            mu = [self.mu[i] for i in group]
            nu = [self.nu[i] for i in group]
            if self.mu_dtype is None:
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, gr, alpha=1.0 - b1)
                m32 = mu
            else:  # fp32 sum of b1_low * mu and (1 - b1) g, stored rounded
                m32 = [t.float() for t in mu]
                torch._foreach_mul_(m32, b1_low)
                torch._foreach_add_(m32, gr, alpha=1.0 - b1)
                torch._foreach_copy_(mu, m32)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, gr, gr, value=1.0 - b2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(m32, bc1)
            torch._foreach_div_(upd, denom)
            del denom, m32
            if self.wd:
                torch._foreach_add_(upd, [t.float() for t in p], alpha=self.wd)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(p, upd)


def jax_layout(name: str, shape) -> tuple[int, ...]:
    """The axes of a port parameter in the order of the JAX package's layout
    (``port.permute(axes)`` has the JAX shape): 4-D ``.weight``s are convs,
    [O, I, kh, kw] here and [kh, kw, I, O] there; 2-D ``.weight``s are
    linears, [O, I] here and [I, O] there; every other parameter (norm
    scales, biases, ``vf_proj.kernel``) has one layout in both. A stack's
    parameter (a TransVAE stage's ``.scan.block.``, the DiT's
    ``blocks.block.``) keeps its leading depth axis first, as the JAX
    stacked leaf does, and maps the others by the same rules; so does a
    stacked expert weight ([depth, E, out, in] here, [depth, E, in, out]
    there)."""
    lead = 1 if _STACKED.search(name) else 0
    nd = len(shape) - lead
    axes = tuple(range(nd))
    if name.endswith(".weight") and nd == 4 and ".experts." not in name:
        axes = (2, 3, 1, 0)
    elif name.endswith(".weight") and nd == 2:
        axes = (1, 0)
    elif name.endswith(".weight") and ".experts." in name:  # [E, out, in] per slice
        axes = (0, 2, 1)
    return tuple(range(lead)) + tuple(a + lead for a in axes)


def factored_dims(name: str, shape):
    """The port axes (row, col) over whose means Adafactor keeps a
    parameter's second moment, or None for a full one: optax's
    ``_factored_dims`` (the two largest dimensions when the second largest
    is >= 128, ties broken by ``np.argsort``) on the
    JAX layout of the parameter, mapped back to the port's axes."""
    axes = jax_layout(name, shape)
    jax_shape = tuple(shape[a] for a in axes)
    if len(jax_shape) < 2:
        return None
    order = np.argsort(jax_shape)
    if jax_shape[order[-2]] < _MIN_DIM_TO_FACTOR:
        return None
    # optax's (d1, d0): v_row is the mean over d0, v_col over d1.
    return axes[int(order[-2])], axes[int(order[-1])]


class Adafactor(_Chain):
    """optax's ``adafactor`` with ``min_dim_size_to_factor=128``,
    ``decay_rate=0.8``, no momentum, no parameter scale and the block-RMS
    clip at 1.0, inside the shared chain (see the module docstring).

    State per trainable parameter: ``v_row`` and ``v_col`` (factored) or
    ``v`` (full), fp32, in the port's axis order."""

    kind = "adafactor"

    def __init__(self, named_params, schedule: Schedule, **chain):
        super().__init__(named_params, schedule, **chain)
        pl = self.placement
        self.full_shapes = [tuple(p.shape) if pl is None else pl.full_shape(n, p)
                            for n, p in zip(self.names, self.params)]
        self.split = [None if pl is None else pl.dim(n) for n in self.names]
        self.dims = [factored_dims(n, shape) for n, shape in zip(self.names, self.full_shapes)]
        self.v_row, self.v_col, self.v = [], [], []
        with torch.no_grad():
            for p, t, d in zip(self.params, self.trainable, self.dims):
                full = t and d is None
                self.v.append(torch.zeros_like(p) if full else None)
                self.v_row.append(p.new_zeros(_drop(p.shape, d[1])) if t and d else None)
                self.v_col.append(p.new_zeros(_drop(p.shape, d[0])) if t and d else None)

    def _state(self) -> dict:
        def named(ts):
            return {n: t for n, t in zip(self.names, ts) if t is not None}
        return {"v_row": named(self.v_row), "v_col": named(self.v_col), "v": named(self.v)}

    def _load(self, state: dict) -> None:
        for key in ("v_row", "v_col", "v"):
            for name, t in zip(self.names, getattr(self, key)):
                if t is not None:
                    t.copy_(state[key][name])

    def _state_dim(self, key: str, name: str) -> int | None:
        i = self.names.index(name)
        s, d = self.split[i], self.dims[i]
        if key == "v" or s is None:
            return s
        dropped = d[1] if key == "v_row" else d[0]
        return None if s == dropped else s - (s > dropped)

    def _mean(self, t: torch.Tensor, dim: int | None, split: bool, n: int,
              keepdim: bool = False) -> torch.Tensor:
        """t.mean over ``dim`` (None: every element), ``n`` elements whole;
        a sum over the model group where ``split``."""
        if not split:
            return t.mean() if dim is None else t.mean(dim=dim, keepdim=keepdim)
        part = t.sum() if dim is None else t.sum(dim=dim, keepdim=keepdim)
        return self.placement.sum_sharded(part) / n

    def _update(self, idx: list[int], grads: list[torch.Tensor], lr: float) -> None:
        # optax's decay schedule in fp32, at the 0-based count of this update.
        decay = 1.0 - torch.tensor(float(self.count), dtype=torch.float32) ** -_DECAY_RATE
        keep = float(1.0 - decay)
        decay = float(decay)
        for i in idx:
            g, p, d = grads[i], self.params[i], self.dims[i]
            s, full = self.split[i], self.full_shapes[i]
            g2 = g * g + _EPS
            if d is not None:
                row, col = d  # optax's d1, d0
                v_row = self.v_row[i].mul_(decay).add_(
                    self._mean(g2, col, s == col, full[col]), alpha=keep)
                v_col = self.v_col[i].mul_(decay).add_(
                    self._mean(g2, row, s == row, full[row]), alpha=keep)
                reduced = row - 1 if row > col else row
                row_mean = self._mean(v_row, reduced, s == row, full[row], keepdim=True)
                row_factor = (v_row / row_mean).pow(-0.5)
                u = g * row_factor.unsqueeze(col) * v_col.pow(-0.5).unsqueeze(row)
            else:
                v = self.v[i].mul_(decay).add_(g2, alpha=keep)
                u = g * v.pow(-0.5)
            rms = self._mean(u.square(), None, s is not None, int(np.prod(full))).sqrt()
            u = u / torch.clamp(rms / _BLOCK_RMS, min=1.0)
            p.add_(u, alpha=-lr)


def _drop(shape, axis: int) -> tuple[int, ...]:
    return tuple(s for k, s in enumerate(shape) if k != axis)


def make_optimizer(named_params, learning_rate: float = 1e-4,
                   warmup_steps: int = 10_000, b1: float = 0.9, b2: float = 0.95,
                   weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                   freeze_encoder: bool = False, nan_skip: bool = True,
                   schedule: Schedule | None = None, mu_dtype: str | None = None,
                   optimizer: str = "adamw", placement=None) -> _Chain:
    """The training optimizer over ``named_params`` (name, tensor) pairs,
    with the JAX ``make_optimizer``'s arguments and defaults: ``AdamW`` or
    ``Adafactor`` (which takes no weight decay and ignores ``b1``, ``b2``
    and ``mu_dtype``, as the JAX chain does). ``placement``: the
    parameters' ``parallel.Placement`` when some are sharded."""
    sched = schedule if schedule is not None else warmup_constant(learning_rate,
                                                                  warmup_steps)
    chain = dict(max_grad_norm=max_grad_norm, freeze_encoder=freeze_encoder,
                 nan_skip=nan_skip, placement=placement)
    if optimizer == "adafactor":
        if weight_decay:
            # The JAX package's refusal: optax's adafactor decay is not
            # scaled by the learning rate.
            raise ValueError(
                "weight_decay with optimizer='adafactor' is not supported: "
                "adafactor's decay is not scaled by the learning rate; use "
                "adamw, or extend make_optimizer with an explicit "
                "adafactor_decay_rate argument")
        return Adafactor(named_params, sched, **chain)
    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return AdamW(named_params, sched, b1=b1, b2=b2, weight_decay=weight_decay,
                 mu_dtype=mu_dtype, **chain)
