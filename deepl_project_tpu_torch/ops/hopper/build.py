"""Build and load the port's CUDA kernels (``deepl_project_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C launcher (``<name>_launch``) and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, which is
loaded with ctypes. Builds happen on first use, into ``csrc/build/`` (listed
in ``.gitignore``), one ``nvcc`` process per source, all started together.
A library's file name carries a hash of its sources and flags, so an edit
rebuilds it. Nothing here falls back: a missing ``nvcc`` or a failed build
raises.
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
# name -> argtypes of <name>_launch (pointers and the stream as c_void_p).
SIGNATURES = {
    "ln_qkv_rope": [_P] * 8 + [_I] * 4 + [_P],
    "attention_core": [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P],
    "proj_bias_gemm": [_P] * 4 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> nvcc output (register/smem report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source on first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel; returns name -> library path. Raises on any failure."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOGS[n] = out
            if proc.returncode != 0:
                failed.append(f"--- {n} (exit {proc.returncode}) ---\n{out}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build([name])[name]))
                fn = getattr(lib, f"{name}_launch")
                fn.argtypes = SIGNATURES[name]
                fn.restype = ctypes.c_int
                _libs[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call ``<name>_launch(*args)``; raise if the launch was refused."""
    err = getattr(library(name), f"{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
