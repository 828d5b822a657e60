"""The system under test, ``deepl_project_tpu_torch``, as the benchmark
drives it: its model built from a configuration file, the benchmark's
weights loaded into it, its launch counters, and the ``kernel.*`` ranges
the benchmark opens around each hand-written kernel launch in a traced run.
"""

from __future__ import annotations

import contextlib

import torch

from ..work import kernels as kwork


def model_config(cfg: dict, attention_impl: str):
    from deepl_project_tpu_torch.config import TransVAEConfig

    return TransVAEConfig(
        variant=cfg["variant"], depths=tuple(cfg["depths"]), base_dims=tuple(cfg["base_dims"]),
        latent_dim=cfg["latent_dim"], input_channels=cfg["input_channels"],
        mlp_ratio=cfg["mlp_ratio"], head_dim=cfg["head_dim"],
        num_cnn_stages=cfg["num_cnn_stages"], mu_clip=cfg["mu_clip"],
        logvar_clip=tuple(cfg["logvar_clip"]), dtype=cfg["dtype"],
        param_dtype=cfg["param_dtype"], attention_impl=attention_impl)


def build_model(cfg: dict, attention_impl: str, device):
    """The port's TransVAE on ``device`` with uninitialised parameters."""
    from deepl_project_tpu_torch.models.transvae import TransVAE

    with torch.device("meta"):
        model = TransVAE(model_config(cfg, attention_impl))
    return model.to_empty(device=device)


@torch.no_grad()
def load(model, state: dict) -> None:
    """Copy the benchmark's reference-layout weights into the model (every
    key, strictly)."""
    model.load_state_dict(state, strict=True)


def build_kernels() -> None:
    """Build (or find built) the port's CUDA sources."""
    from deepl_project_tpu_torch.ops.hopper import build

    build.build()


def launch_counts() -> dict[str, int]:
    """Hand-written kernel launches by path since the last reset, and the
    attention routes taken."""
    from deepl_project_tpu_torch.ops import attention
    from deepl_project_tpu_torch.ops.hopper import (flash_attention, fused_attention_block,
                                                    fused_norm, small_attention)

    out = {}
    for mod in (flash_attention, fused_attention_block, fused_norm, small_attention):
        for k, v in mod.launch_counts().items():
            out[k] = out.get(k, 0) + v
    out.update({f"route.{k}": v for k, v in attention.route_counts().items()})
    return out


def reset_launch_counts() -> None:
    from deepl_project_tpu_torch.ops import attention
    from deepl_project_tpu_torch.ops.hopper import (flash_attention, fused_attention_block,
                                                    fused_norm, small_attention)

    for mod in (flash_attention, fused_attention_block, fused_norm, small_attention):
        mod.reset_launch_counts()
    attention.reset_route_counts()


class KernelLog:
    """While ``active``, every launch of a hand-written kernel runs inside a
    ``kernel.<launcher>`` profiler range and adds its bound time (from the
    launch's shapes, ``work.kernels``) to ``bound_s[launcher]``."""

    def __init__(self):
        from deepl_project_tpu_torch.ops.hopper import build

        self.build, self.orig = build, build.launch
        self.active = False
        self.bound_s: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        build.launch = self._launch

    def _launch(self, name, *args):
        if not self.active:
            return self.orig(name, *args)
        with torch.profiler.record_function(f"kernel.{name}"):
            self.orig(name, *args)
        self.bound_s[name] = self.bound_s.get(name, 0.0) + kwork.bound_s(
            name, kwork.ints(name, args))
        self.calls[name] = self.calls.get(name, 0) + 1

    def close(self) -> None:
        self.build.launch = self.orig


@contextlib.contextmanager
def kernel_log(enabled: bool):
    log = KernelLog() if enabled else None
    try:
        yield log
    finally:
        if log is not None:
            log.close()
