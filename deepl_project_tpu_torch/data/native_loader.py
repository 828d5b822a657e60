"""ctypes bindings for the native C++ image decoder (PyTorch port of
``data/native_loader.py``).

The decoder's source is the repository's ``native/image_loader.cpp``:
threaded JPEG/PNG decode, shorter-side resize with Pillow's antialiased
bilinear filter, centre crop, float32 [0, 1] HWC. The port builds its own
copy on first use with the flags of ``native/Makefile`` (so both packages'
decoders give the same bits on one host) into the port's gitignored
``csrc/build/``: under a file lock, to a temporary name, then renamed, so
processes that build at once never load a half-written library. The
library's name carries a hash of the source, the flags and the host's CPU
(the flags hold ``-march=native``). ``native/`` is never written.

Where the library cannot be built or loaded, :func:`native_available` is
false and :func:`build_error` says why; the data sources then decode with
PIL, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import random
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "image_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lock = threading.Lock()
_lib = None
_tried = False
_error: str | None = None


def _cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return platform.processor()


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(f"{platform.machine()} {_cpu()}".encode())
    return BUILD_DIR / f"libdeepl_loader_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile SOURCE into ``path`` unless another process already has;
    raises RuntimeError with the compiler's output on failure."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "deepl_loader.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} exited {out.returncode}:\n{out.stderr.strip()}")
        os.replace(tmp, path)


def _load():
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = str(e)
            return None
        lib.dt_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.dt_decode_file.restype = ctypes.c_int
        lib.dt_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte)]
        lib.dt_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library built (or was built) and loaded in this process."""
    return _load() is not None


def build_error() -> str | None:
    """Why the library is not available (the compiler's or loader's error),
    or None."""
    _load()
    return _error


def decode_file(path: str, resolution: int = 256) -> np.ndarray | None:
    """One image decoded and preprocessed to [res, res, 3] float32; None
    when the file cannot be read or decoded."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((resolution, resolution, 3), np.float32)
    ok = lib.dt_decode_file(path.encode(), resolution,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if ok else None


def decode_batch(paths: list[str], resolution: int = 256,
                 num_threads: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Decode on ``num_threads`` C++ threads (ctypes releases the GIL) ->
    ([N, res, res, 3] float32, [N] bool ok mask; failed rows are zero)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native image decoder unavailable: {_error}")
    n = len(paths)
    out = np.empty((n, resolution, resolution, 3), np.float32)
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.dt_decode_batch(arr, n, resolution, num_threads,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out, ok.astype(bool)


def native_folder_batches(root: str, resolution: int = 256,
                          batch_size: int = 16, num_threads: int = 8,
                          shuffle: bool = True, seed: int = 42,
                          drop_last: bool = True):
    """[B, res, res, 3] batches over a folder tree (recursive, sorted, then
    shuffled with ``random.Random(seed)``); a batch's unreadable files are
    dropped from it."""
    from .datasets import list_images

    files = list_images(root)
    if shuffle:
        random.Random(seed).shuffle(files)
    for i in range(0, len(files) - (batch_size - 1 if drop_last else 0), batch_size):
        batch, ok = decode_batch(files[i:i + batch_size], resolution, num_threads)
        if ok.all():
            yield batch
        elif ok.any():
            yield batch[ok]
