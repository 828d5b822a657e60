"""The training optimizer (PyTorch port of ``training/optim.py``, its
``adamw`` branch).

``make_optimizer`` builds what the JAX package's optax chain computes,
written out over tensors (``torch._foreach_*``):

    apply_if_finite(                      # NaN-skip, max_consecutive_errors
      multi_transform(                    # freeze_encoder: encoder -> zeros
        chain(clip_by_global_norm(max_grad_norm),
              adamw(schedule, b1, b2, eps, weight_decay, mu_dtype))))

- A step whose gradients hold a non-finite value changes nothing (params,
  moments, counts), unless more than ``max_consecutive_errors`` such steps
  came in a row; ``notfinite_count`` / ``total_notfinite`` count them.
- The clip is optax's: g * max_norm / norm when norm >= max_norm (no 1e-6
  term), over the trainable gradients only.
- AdamW: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, bias-corrected
  with the update count, u = mu_hat / (sqrt(nu_hat) + eps) + wd * p, and the
  step is -lr(count) * u with the schedule read at the 0-based count of
  applied updates. With ``mu_dtype='bfloat16'`` mu is stored in bf16 and
  updated as bf16(b1) * mu + (1 - b1) * g in fp32, as the compiled optax
  chain computes it.
- ``freeze_encoder``: parameters whose name has an ``encoder`` component get
  zero updates and no moments, and stay out of the clip norm.

The update is in place on the parameters and on the gradients handed in.
``torch.optim.AdamW`` differs in each of these points (epsilon placement
aside, its clip helper adds 1e-6 and it has no NaN-skip), hence this class.
"""

from __future__ import annotations

import torch

from .schedule import Schedule, warmup_constant

# Tensors per foreach group: bounds the update's temporaries.
_GROUP_NUMEL = 1 << 26


def _is_frozen(name: str) -> bool:
    return "encoder" in name.split(".")


class AdamW:
    """AdamW with global-norm clipping, NaN-skip and an optional frozen
    encoder over named parameters (see the module docstring)."""

    def __init__(self, named_params, schedule: Schedule, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, freeze_encoder: bool = False,
                 nan_skip: bool = True, mu_dtype: str | None = None,
                 max_consecutive_errors: int = 100):
        self.names, self.params = map(list, zip(*named_params))
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.max_grad_norm = max_grad_norm
        self.nan_skip = nan_skip
        self.max_consecutive_errors = max_consecutive_errors
        self.trainable = [not (freeze_encoder and _is_frozen(n)) for n in self.names]
        self.mu_dtype = getattr(torch, mu_dtype) if mu_dtype else None
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) if t else None
                       for p, t in zip(self.params, self.trainable)]
            self.nu = [torch.zeros_like(p) if t else None
                       for p, t in zip(self.params, self.trainable)]
        self.count = 0  # applied updates
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.last_finite = True

    # -- state -------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"count": self.count, "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite,
                "last_finite": self.last_finite,
                "mu": {n: m for n, m in zip(self.names, self.mu) if m is not None},
                "nu": {n: v for n, v in zip(self.names, self.nu) if v is not None}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for key in ("count", "notfinite_count", "total_notfinite", "last_finite"):
            setattr(self, key, state[key])
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

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> bool:
        """Apply one update from fp32 ``grads`` (one per parameter, modified
        in place); returns False when the step was skipped as non-finite."""
        finite = True
        if self.nan_skip:
            amax = torch.stack(torch._foreach_norm(grads, float("inf")))
            finite = bool(torch.isfinite(amax).all())
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
        norm = torch.stack(torch._foreach_norm(g)).norm()
        if bool(norm >= self.max_grad_norm):
            torch._foreach_div_(g, norm)
            torch._foreach_mul_(g, self.max_grad_norm)

        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - float(torch.tensor(b1) ** self.count)
        bc2 = 1.0 - float(torch.tensor(b2) ** self.count)
        lr = self.schedule(self.count - 1)
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
        return True


def make_optimizer(named_params, learning_rate: float = 1e-4,
                   warmup_steps: int = 10_000, b1: float = 0.9, b2: float = 0.95,
                   weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                   freeze_encoder: bool = False, nan_skip: bool = True,
                   schedule: Schedule | None = None, mu_dtype: str | None = None,
                   optimizer: str = "adamw") -> AdamW:
    """The training optimizer over ``named_params`` (name, tensor) pairs,
    with the JAX ``make_optimizer``'s arguments and defaults."""
    if optimizer == "adafactor":
        raise NotImplementedError("optimizer='adafactor' is not yet ported to "
                                  "deepl_project_tpu_torch")
    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    sched = schedule if schedule is not None else warmup_constant(learning_rate,
                                                                  warmup_steps)
    return AdamW(named_params, sched, b1=b1, b2=b2, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm, freeze_encoder=freeze_encoder,
                 nan_skip=nan_skip, mu_dtype=mu_dtype)
