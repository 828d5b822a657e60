"""The run's surroundings: cache directories, the guards on the device and
on JAX, and what the card and its toolchain say about themselves."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from .spec import ROOT

# Top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the latter's).
FORBIDDEN = ("jax", "jaxlib", "flax", "deepl_project_tpu")
CACHE = ROOT / ".bench_cache"


def prepare() -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run in a checkout builds (the port's own kernel builds go to its
    ``csrc/build``, also inside the checkout); no library may load JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"this cell needs {chips} CUDA device(s); found {n}")


def smi() -> str:
    """The card's name, clocks, power draw and limit, and temperature."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run([exe, "--query-gpu=name,clocks.sm,clocks.mem,power.draw,power.limit,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip() or out.stderr.strip()


def nvcc_version() -> str:
    exe = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                               "bin", "nvcc")
    if not os.path.exists(exe):
        return "nvcc not found"
    out = subprocess.run([exe, "--version"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else out.stderr.strip()
