"""The PyTorch port stands alone: no JAX, nothing of deepl_project_tpu.

In a fresh interpreter where ``import jax`` and ``import flax`` fail, every
module of deepl_project_tpu_torch (found by walking the whole package, so new
modules are covered as they come; the evaluation slice's are named) and
chip_smoke.py must import, and none of deepl_project_tpu's modules may be
loaded (the parallel slice's modules are named too). The entry points
(model factory, ``from_pretrained``, serving engine, trainer -- also with a
VF teacher, remat and Adafactor -- the evaluate, generate, rope_extrapolation
and smoke_test CLIs, the DiT factory and the train_dit and sample_dit CLIs,
and the train CLI as torchrun starts it) default to CUDA and refuse to
continue on a machine without it.
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
    named = {"evaluation", "utils.fid", "utils.image", "ops.hopper.small_attention",
             "ops.hopper.fused_norm", "cli.evaluate", "cli.generate",
             "cli.rope_extrapolation", "data.transforms", "quantize", "ops.quant",
             "models.discriminator", "losses.teachers", "data.native_loader",
             "data.datasets", "utils.inception", "utils.inception_spec",
             "utils.latent_metrics", "utils.logging", "utils.flops", "cli.smoke_test",
             "models.dit", "ops.moe", "training.diffusion", "cli.train_dit",
             "cli.sample_dit", "parallel", "parallel.multihost", "parallel.mesh",
             "parallel.collectives", "parallel.sharding", "parallel.ring_attention",
             "parallel.context", "parallel.halo", "parallel.dryrun", "parallel.pipeline",
             "ops.stack", "ops.thin_conv"}
    assert named <= {n.split(".", 1)[1] for n in names}, named
    import chip_smoke
    bad = sorted(m for m in sys.modules
                 if m == "deepl_project_tpu" or m.startswith("deepl_project_tpu."))
    assert not bad, bad
    assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
    print(len(names))
    if not torch_cuda:
        from deepl_project_tpu_torch import create_transvae, from_pretrained, get_config
        from deepl_project_tpu_torch.cli import (evaluate, generate, rope_extrapolation,
                                                 sample_dit, serve, smoke_test, train_dit)
        from deepl_project_tpu_torch.models import create_dit, get_dit_config
        from deepl_project_tpu_torch.losses import LossWeights, make_stub_teacher
        from deepl_project_tpu_torch.training import Trainer, TrainerConfig
        for fn in (lambda: create_transvae("tiny"),
                   lambda: serve.build_engine(serve.build_parser().parse_args([])),
                   lambda: Trainer(get_config("tiny"),
                                   TrainerConfig(weights=LossWeights(gan=0.0))),
                   lambda: Trainer(get_config("tiny"), TrainerConfig(weights=LossWeights())),
                   lambda: Trainer(get_config("tiny", remat=True),
                                   TrainerConfig(weights=LossWeights(gan=0.0),
                                                 optimizer="adafactor"),
                                   teacher_fn=make_stub_teacher()),
                   lambda: evaluate.main([]), lambda: generate.main([]),
                   lambda: rope_extrapolation.main([]), lambda: smoke_test.main([]),
                   lambda: from_pretrained("transvae-tiny-f16d32"),
                   lambda: create_dit(get_dit_config("S")), lambda: train_dit.main([]),
                   lambda: sample_dit.main(["--checkpoint", "none"])):
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
    assert int(n_modules) >= 50 and status == "ok"


_TORCHRUN_PROBE = textwrap.dedent("""
    import sys, tempfile
    sys.modules["jax"] = None
    import torch
    import torch.distributed as dist
    torch.cuda.is_available = lambda: False
    from deepl_project_tpu_torch.cli import train
    out = tempfile.mkdtemp()
    try:
        train.main(["--data", "shapes", "--output_dir", out, "--mesh_model", "2",
                    "--param_sharding", "tensor"])
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("trained without CUDA")
    assert not dist.is_initialized()
    print("ok")
""")


def test_train_cli_under_torchrun_refuses_without_cuda(tmp_path):
    """cli.train with torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_*
    set and CUDA hidden: the default device stays the card, so it raises
    before it joins a process group, as the single-process path does."""
    env = {**os.environ, "PYTHONPATH": REPO, "RANK": "0", "WORLD_SIZE": "2",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
           "MASTER_PORT": "29500", "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", _TORCHRUN_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=30, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]
