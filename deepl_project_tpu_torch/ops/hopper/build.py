"""Build and load the port's CUDA kernels (``deepl_project_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` (headers: ``csrc/*.cuh``) has a plain C launcher
(``<name>_launch``; a source with two kernels has one per kernel, listed in
``SOURCE_OF``) and is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library, which is loaded with ctypes. Builds happen on first use, into ``csrc/build/`` (listed
in ``.gitignore``), one ``nvcc`` process per source, all started together.
A library's file name carries a hash of its sources and flags, so an edit
rebuilds it. ``csrc`` names another source directory (another checkout's,
to time its kernels beside these); its libraries share ``csrc/build/`` under
their own hashes. Nothing here falls back: a missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# kernel name -> argtypes of <name>_launch (pointers and the stream as c_void_p).
SIGNATURES = {
    "ln_qkv_rope": [_P] * 9 + [_I] * 5 + [_P],
    "attention_core": [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P],
    "proj_bias_gemm": [_P] * 4 + [_I] * 3 + [_P],
    "flash_attention_fwd": [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P],
    "flash_attention_bwd": [_P] * 11 + [_I] * 10 + [ctypes.c_float, _P],
    "flash_attention_bwd_det": [_P] * 11 + [_I] * 10 + [ctypes.c_float, _P],
    "small_attention": [_P] * 4 + [_I] * 7 + [ctypes.c_float, _P],
    "group_norm_stats": [_P] * 2 + [_I] * 5 + [_P],
    "group_norm_apply": [_P, _P, _I, _P, _P, _P] + [_I] * 6 + [ctypes.c_float, _I, _P],
}
# Kernels whose launcher lives in a source of another name (csrc/<source>.cu).
SOURCE_OF = {"group_norm_stats": "group_norm_silu", "group_norm_apply": "group_norm_silu",
             "flash_attention_bwd_det": "flash_attention_bwd"}


def sources() -> list[str]:
    """The names of every kernel source, csrc/<name>.cu."""
    return sorted({SOURCE_OF.get(n, n) for n in SIGNATURES})


_lock = threading.Lock()
_fns: dict = {}  # (source directory, kernel name) -> its loaded launcher
# name (or "name [source directory]" for another csrc) -> nvcc output, which
# carries ptxas' register/smem report.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source on first use")


def _lib_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for src in [csrc / f"{name}.cu"] + sorted(csrc.glob("*.cuh")):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None, csrc: Path = CSRC) -> dict[str, Path]:
    """Compile the named kernel sources (default: all) of ``csrc`` that are
    not built yet, in parallel; returns name -> library path. Raises on any
    failure."""
    names = sources() if names is None else list(names)
    csrc = Path(csrc).resolve()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n, csrc) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOGS[n if csrc == CSRC else f"{n} [{csrc}]"] = out
            if proc.returncode != 0:
                failed.append(f"--- {n} (exit {proc.returncode}) ---\n{out}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def launcher(name: str, csrc: Path = CSRC, argtypes=None):
    """``<name>_launch`` of kernel ``name`` from ``csrc``, its source built on
    first use; ``argtypes`` (default ``SIGNATURES[name]``) names the
    signature of a launcher this tree no longer has."""
    key = (Path(csrc).resolve(), name)
    fn = _fns.get(key)
    if fn is None:
        with _lock:
            fn = _fns.get(key)
            if fn is None:
                src = SOURCE_OF.get(name, name)
                fn = getattr(ctypes.CDLL(str(build([src], key[0])[src])), f"{name}_launch")
                fn.argtypes = SIGNATURES[name] if argtypes is None else argtypes
                fn.restype = ctypes.c_int
                _fns[key] = fn
    return fn


# Threads whose CUDA context is known to be current (see launch()).
_bound = threading.local()


def launch(name: str, *args) -> None:
    """Call ``<name>_launch(*args)``; raise if the launch was refused.

    Each launcher library links its own CUDA runtime, which launches into
    the context current on the calling thread. PyTorch makes the device's
    primary context current on a thread only when it calls the runtime
    there, and a thread that has taken its tensors from the caching
    allocator (autograd's device threads, a Python thread) may never have:
    the launch then fails with 201 (invalid context). So the first launch
    on each thread has PyTorch's runtime touch its current stream first."""
    if not getattr(_bound, "ok", False):
        import torch

        torch.cuda.current_stream().query()
        _bound.ok = True
    err = launcher(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
