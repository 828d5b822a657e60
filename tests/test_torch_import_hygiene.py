"""The PyTorch port stands alone: no JAX, nothing of deepl_project_tpu.

In a fresh interpreter where ``import jax`` and ``import flax`` fail, every
module of deepl_project_tpu_torch and chip_smoke.py must import, and none of
deepl_project_tpu's modules may be loaded. The entry points default to CUDA
and refuse to continue on a machine without it.
"""

import os
import subprocess
import sys
import textwrap

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    import deepl_project_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    bad = sorted(m for m in sys.modules
                 if m == "deepl_project_tpu" or m.startswith("deepl_project_tpu."))
    assert not bad, bad
    assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
    print(len(names))
    if not torch_cuda:
        from deepl_project_tpu_torch import create_transvae
        from deepl_project_tpu_torch.cli import serve
        for fn in (lambda: create_transvae("tiny"),
                   lambda: serve.build_engine(serve.build_parser().parse_args([]))):
            try:
                fn()
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise AssertionError("built a model without CUDA")
    print("ok")
""")


def test_port_imports_without_jax_or_the_jax_package():
    code = f"torch_cuda = {torch.cuda.is_available()}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    n_modules, status = out.stdout.split()
    assert int(n_modules) >= 15 and status == "ok"
