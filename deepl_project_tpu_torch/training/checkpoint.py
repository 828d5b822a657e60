"""Checkpoint save/resume with ``torch.save`` (PyTorch port of
``training/checkpoint.py``).

A checkpoint directory holds ``ckpt_<step>.pt`` files -- {'state': {'model':
reference-layout state_dict, 'optimizer': ..., 'step': ..., ['ema': ...],
['vf_proj': ...]}, 'meta': {'epoch', 'step'}} -- the newest ``max_to_keep`` of them, a
``config.json`` beside them and, for a best checkpoint, ``metrics.json``.
Files are written to a temporary name and renamed, so a crash mid-save
leaves the previous checkpoints whole.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

from ..config import TransVAEConfig

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:09d}.pt")


def save_checkpoint(directory: str, step: int, state: dict, epoch: int = 0,
                    config: TransVAEConfig | None = None, max_to_keep: int = 3,
                    metrics: dict[str, float] | None = None) -> str:
    """Save ``state`` at ``step``; keep the newest ``max_to_keep``."""
    os.makedirs(directory, exist_ok=True)
    if config is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2, default=list)
    if metrics:
        with open(os.path.join(directory, "metrics.json"), "w") as f:
            json.dump({"step": step, **{k: float(v) for k, v in metrics.items()}},
                      f, indent=1)
    path = _path(directory, step)
    tmp = path + f".{os.getpid()}.tmp"
    torch.save({"state": state, "meta": {"epoch": epoch, "step": step}}, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    return path


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int | None = None,
                       map_location="cpu") -> tuple[dict, dict]:
    """(state, meta) of ``step`` (default: the newest)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint found in {directory}")
    raw = torch.load(_path(directory, step), map_location=map_location,
                     weights_only=True)
    return raw["state"], raw["meta"]


def restore_model_params(directory: str, step: int | None = None, prefer_ema: bool = True,
                         map_location="cpu") -> dict:
    """The model's state_dict alone from a trainer checkpoint (the JAX
    ``restore_model_params``): with ``prefer_ema`` the EMA shadow's
    parameters where the checkpoint has one (the model the best checkpoint
    scored), without the optimizer, the VF projection or the discriminator.
    The file is memory-mapped, so the optimizer's tensors are not read."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint found in {directory}")
    raw = torch.load(_path(directory, step), map_location="cpu", weights_only=True,
                     mmap=True)
    state = raw["state"]
    model = dict(state["model"])
    if prefer_ema and state.get("ema") is not None:
        model.update({k: state["ema"][k] for k in model if k in state["ema"]})
    return {k: v.to(map_location) for k, v in model.items()}


def checkpoint_metrics(directory: str) -> dict | None:
    """The metrics.json written with a best checkpoint, or None."""
    path = os.path.join(directory, "metrics.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_config(directory: str) -> TransVAEConfig:
    with open(os.path.join(directory, "config.json")) as f:
        raw = json.load(f)
    for key in ("depths", "base_dims", "logvar_clip"):
        raw[key] = tuple(raw[key])
    return TransVAEConfig(**raw)
