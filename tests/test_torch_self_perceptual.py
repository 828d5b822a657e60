"""The port's self-perceptual term (``losses.make_self_perceptual``) and its
trainer wiring (``perceptual='self'``), against the JAX package on the CPU.

- The distances and their gradient with respect to the reconstruction
  against JAX's ``make_self_perceptual`` on the same frozen weights.
- A port checkpoint loads through ``perceptual_checkpoint``: the trainer
  builds the net from its saved config and EMA parameters, prints JAX's
  banner, and the term enters the training loss in the LPIPS slot; with
  the lpips weight 0 the banner is printed and the term is not trained (the
  JAX trainer's quirk, mirrored).

Tolerance: 1e-5 relative to the largest value (distances; the gradient
1e-5 x its largest entry): fp32 through a micro encoder, sums in other
orders.
"""

import jax
import numpy as np
import pytest
import torch

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses.vae_loss import make_self_perceptual as jax_make_self_perceptual
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.losses import LossWeights, make_self_perceptual
from deepl_project_tpu_torch.models import TransVAE, init_weights
from deepl_project_tpu_torch.training import (Trainer, TrainerConfig, restore_model_params)
from deepl_project_tpu_torch.training.train_step import compute_grads
from deepl_project_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(2)
VARIANT = "tiny_f8d16"
MICRO = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), latent_dim=4, head_dim=16,
             dtype="float32", attention_impl="auto_train", use_dc_path=False)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def shared():
    cfg = get_config(VARIANT, **MICRO)
    src = TransVAE(cfg, device="cpu")
    init_weights(src, torch.Generator().manual_seed(0))
    params = torch_state_dict_to_params({k: v.numpy() for k, v in src.state_dict().items()},
                                        jax_get_config(VARIANT, **MICRO))
    rng = np.random.default_rng(3)
    images = [rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(2)]
    return params, images


def test_self_perceptual_matches_jax(shared):
    params, (recon, target) = shared
    jfn = jax_make_self_perceptual(JaxTransVAE(jax_get_config(VARIANT, **MICRO)), params)

    def total(r):
        d = jfn(r, target)
        return d.sum(), d

    (_, want), want_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(recon)
    want, want_grad = np.asarray(want), np.asarray(want_grad)

    net = TransVAE(get_config(VARIANT, **MICRO), device="cpu")
    load_jax_params(net, params)
    fn = make_self_perceptual(net)
    assert not any(p.requires_grad for p in net.parameters())
    r = _nchw(recon).requires_grad_(True)
    got = fn(r, _nchw(target))
    got.sum().backward()
    assert got.shape == (2,) and float(got.detach().min()) > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    g = r.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(g, want_grad, rtol=0, atol=1e-5 * np.abs(want_grad).max())
    # The frozen net's state loads through frozen_state; no grad reaches it.
    other = TransVAE(get_config(VARIANT, **MICRO), device="cpu")
    same = make_self_perceptual(other, net.state_dict())(_nchw(recon), _nchw(target))
    assert torch.equal(same, got.detach())
    assert all(p.grad is None for p in net.parameters())


@pytest.mark.parametrize("lpips", [1.0, 0.0])
def test_perceptual_checkpoint_loads_into_the_trainer(shared, tmp_path, capsys, lpips):
    params, (recon, target) = shared
    # A port checkpoint with an EMA shadow unlike its parameters.
    src = Trainer(get_config(VARIANT, **MICRO),
                  TrainerConfig(weights=LossWeights(lpips=0.0, gan=0.0), ema_decay=0.99,
                                output_dir=str(tmp_path / "src")), device="cpu")
    state = src.create_state()
    load_jax_params(state.model, params)
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            state.ema[n].copy_(p * 0.5)
    src.save(state, epoch=0)
    ckpt = str(tmp_path / "src" / "checkpoints")
    capsys.readouterr()

    cfg = TrainerConfig(weights=LossWeights(lpips=lpips, gan=0.0, kl=1e-2),
                        perceptual="self", perceptual_checkpoint=ckpt,
                        output_dir=str(tmp_path / "run"))
    trainer = Trainer(get_config(VARIANT, **MICRO), cfg, device="cpu")
    assert capsys.readouterr().out == (
        f"[trainer] perceptual=self: LPIPS slot uses the frozen encoder from {ckpt} "
        "(self-perceptual distance, NOT VGG-LPIPS)\n")
    assert trainer.lpips_params is None
    ema_net = TransVAE(get_config(VARIANT, **MICRO), device="cpu")
    ema_net.load_state_dict(state.model.state_dict())
    with torch.no_grad():
        for n, p in ema_net.named_parameters():
            p.mul_(0.5)
    want = make_self_perceptual(ema_net)(_nchw(recon), _nchw(target))
    assert torch.equal(trainer.perceptual_fn(_nchw(recon), _nchw(target)), want)
    raw = restore_model_params(ckpt, prefer_ema=False)
    assert all(torch.equal(raw[n], t) for n, t in state.model.state_dict().items())

    model = trainer.create_state().model
    grads, metrics = compute_grads(model, torch.from_numpy(recon), cfg.weights, sample=False,
                                   perceptual_fn=trainer.perceptual_fn)
    assert (float(metrics["lpips"]) > 0) == (lpips > 0)
    assert all(torch.isfinite(g).all() for g in grads)
