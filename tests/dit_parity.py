"""Shared set-up of the latent-DiT parity tests (``tests/test_torch_dit*.py``,
``test_torch_moe.py``, ``test_torch_diffusion.py``): the micro DiT of
``tests/test_dit.py`` (hidden 64, depth 2, 2 heads, 4 latent channels, 10
classes) in both packages, with random parameters drawn with numpy on the
JAX tree's shapes (``jax.eval_shape`` of the init: no compile) and converted
into the port with ``utils.convert.load_jax_dit_params``. Every parameter is
random, the zero-initialised heads too, so every block shapes the output.
Label dropout is off (``class_dropout=0``): the two packages draw it from
streams that never agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepl_project_tpu.models import DiT as JaxDiT
from deepl_project_tpu.models import get_dit_config as jax_get_dit_config
from deepl_project_tpu_torch.models import DiT, DiTConfig
from deepl_project_tpu_torch.utils.convert import load_jax_dit_params

MICRO = dict(hidden_dim=64, depth=2, num_heads=2, in_channels=4, num_classes=10)


def jax_cfg(dtype: str = "float32", **kw):
    cfg = jax_get_dit_config("B", 2, dtype=dtype, attention_impl="xla", class_dropout=0.0)
    return cfg.replace(**{**MICRO, **kw})


def port_cfg(cfg) -> DiTConfig:
    """The JAX config's fields, as a ``dit_config.json`` sidecar carries them."""
    return DiTConfig(**dataclasses.asdict(cfg))


def random_params(model, grid: int = 8, seed: int = 0, scale: float = 0.1) -> dict:
    """A param tree of ``model``'s shapes, N(0, scale^2) float32 leaves."""
    c = model.config.in_channels
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, grid, grid, c)),
        jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def make_pair(dtype: str = "float32", grid: int = 8, seed: int = 0, **kw):
    """(JAX model, its params, the port's model holding the same weights)."""
    jm = JaxDiT(jax_cfg(dtype, **kw))
    params = random_params(jm, grid, seed)
    pm = DiT(port_cfg(jm.config), grid)
    load_jax_dit_params(pm, params)
    return jm, params, pm


def jax_forward(model):
    return jax.jit(lambda p, z, t, y: model.apply({"params": p}, z, t, y))


def inputs(b: int = 2, grid: int = 8, c: int = 4, seed: int = 1):
    """(z [B, grid, grid, C], t [B], labels [B]) as numpy, the last label
    the null class."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, grid, grid, c)).astype(np.float32)
    t = rng.uniform(size=b).astype(np.float32)
    y = rng.integers(0, MICRO["num_classes"], b).astype(np.int32)
    y[-1] = MICRO["num_classes"]
    return z, t, y


def torch_args(z, t, y):
    return torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y).long()


def phase5_cfg(**kw):
    """The JAX dry run's phase-5 DiT (DiT-S geometry cut to depth 4, width
    64, 4 heads, fp32, 10 classes, no label dropout) on 8-channel latents."""
    return jax_get_dit_config("S").replace(
        depth=4, hidden_dim=64, num_heads=4, dtype="float32", param_dtype="float32",
        num_classes=10, class_dropout=0.0, in_channels=8, **kw)


def jax_step_draws(rng, shape):
    """t and the noise as the JAX ``make_dit_train_step`` draws them at step 0
    (``fold_in(rng, 0)``, then ``rectified_flow_loss``'s split), numpy."""
    t_rng, n_rng, _ = jax.random.split(jax.random.fold_in(rng, 0), 3)
    t = jax.nn.sigmoid(jax.random.normal(t_rng, (shape[0],), jnp.float32))
    return np.asarray(t), np.asarray(jax.random.normal(n_rng, shape, jnp.float32))
