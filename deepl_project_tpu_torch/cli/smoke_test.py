"""Installation smoke test (PyTorch port of ``cli/smoke_test.py``): the
reference's test_installation.py as a CLI, six self-contained checks on
random weights of a small model, exit code 0 or 1.

Usage:
  python -m deepl_project_tpu_torch.cli.smoke_test            # on CUDA
  python -m deepl_project_tpu_torch.cli.smoke_test --device cpu
"""

from __future__ import annotations

import argparse
import sys
import traceback

import torch


def _small_model(device, **kw):
    from ..config import get_config
    from ..models import TransVAE, init_weights

    cfg = get_config("tiny_f16d32", **kw).replace(
        depths=(1, 1, 1, 1, 1), base_dims=(32, 32, 64, 64, 128), latent_dim=8)
    model = TransVAE(cfg, device=device)
    return init_weights(model, torch.Generator(device=device).manual_seed(0)).eval()


def _x(device, model, res):
    return torch.zeros(1, 3, res, res, device=device, dtype=model.config.compute_dtype)


def check_model_creation(device):
    from ..config import VARIANTS, get_config

    for key in VARIANTS:
        cfg = get_config(key)
        assert cfg.num_stages == len(cfg.depths)
    return True


@torch.no_grad()
def check_forward_shapes(device):
    model = _small_model(device)
    x = _x(device, model, 64)
    recon, mu, logvar = model(x)
    assert recon.shape == x.shape
    assert mu.shape == (1, 8, 4, 4)
    return True


@torch.no_grad()
def check_encode_decode(device):
    model = _small_model(device)
    x = _x(device, model, 64)
    mu, logvar = model.encode(x)
    assert model.decode(mu).shape == x.shape
    return True


@torch.no_grad()
def check_resolution_flexibility(device):
    model = _small_model(device)
    for res in (32, 64, 128):
        recon, *_ = model(_x(device, model, res))
        assert recon.shape == (1, 3, res, res), res
    return True


def check_gradient_checkpointing(device):
    model = _small_model(device, remat=True).train()
    recon, *_ = model(_x(device, model, 32))
    recon.float().square().mean().backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    return True


def check_compression_ratios(device):
    from ..config import get_config

    assert get_config("tiny_f16d32").compression_ratio == 16
    assert get_config("large_f8d16").compression_ratio == 8
    return True


CHECKS = [
    ("Model creation (all variants)", check_model_creation),
    ("Forward pass shapes", check_forward_shapes),
    ("Encode/decode round trip", check_encode_decode),
    ("Resolution flexibility (RoPE)", check_resolution_flexibility),
    ("Gradient checkpointing backward", check_gradient_checkpointing),
    ("Compression ratio contracts", check_compression_ratios),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="deepl_project_tpu_torch installation smoke test")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    from ..models.transvae import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"deepl_project_tpu_torch smoke test on {device} ({name})")
    failures = 0
    for label, fn in CHECKS:
        try:
            fn(device)
            print(f"  [PASS] {label}")
        except Exception:  # noqa: BLE001 -- each check reports and the next runs
            failures += 1
            print(f"  [FAIL] {label}")
            traceback.print_exc()
    print(f"{len(CHECKS) - failures}/{len(CHECKS)} checks passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
