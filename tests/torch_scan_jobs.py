"""Rank jobs of tests/test_torch_scan_parallel.py (JAX-free: the ranks of
tests/torch_parallel_jobs.py's RankPool import this module by name): the
scan layout (``scan_blocks``) of the micro model under FSDP and tensor
parallelism on gloo CPU ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import torch_parallel_jobs as J

# The scan model of the tests: the micro model of torch_parallel_jobs with
# two blocks a stage, so every stack has a depth of 2.
SCAN = {"scan_blocks": True, "depths": (2, 2, 2, 2)}
UNROLLED = {"depths": (2, 2, 2, 2)}


# The model of the JAX comparisons: tests/test_torch_scan_blocks.py's (tiny
# f16d32 cut to three stages of two blocks, seed 8). On the four-stage
# micro model the L1 term's sign flips put one process 6e-5 from JAX in
# grad norm already (conv_mu's gradient); on this one it lies within 2e-6.
JAX_VARIANT = "tiny_f16d32"
JAX_MODEL = dict(depths=(2, 2, 2), base_dims=(16, 16, 32), latent_dim=4, head_dim=16,
                 dtype="float32", attention_impl="auto_train", scan_blocks=True)
JAX_SEED = 8


def jax_model():
    from deepl_project_tpu_torch import create_transvae

    return create_transvae(JAX_VARIANT, device="cpu", seed=JAX_SEED, **JAX_MODEL)


def grads(mode: str, model_size: int, batch: np.ndarray) -> dict:
    """The stage-1 loss (the latent's mean decoded, L1 + KL) of
    :func:`jax_model` and its global grad norm, on the process group's ranks
    under ``mode`` at model ``model_size`` (each data rank its rows)."""
    from deepl_project_tpu_torch.parallel import shard_batch
    from deepl_project_tpu_torch.training.train_step import (compute_grads, global_norm,
                                                             named_trainables)

    model = jax_model()
    placement, mesh = J._place(model, mode, model_size)
    named = named_trainables(model)
    g, metrics = compute_grads(model, torch.as_tensor(shard_batch(mesh, batch)), J._weights(),
                               sample=False, placement=placement)
    names = [n for n, _ in named]
    return {"loss": float(metrics["total"]),
            "grad_norm": float(global_norm(g, placement, names)),
            "split": [n for n in names if placement.dim(n) is not None]}


def stack_split_on_depth(world_split: bool) -> dict:
    """A BlockStack of depth 8 whose FSDP axis is its depth axis (a [8, 4,
    2] weight's largest divisible axis): this rank holds 8 / world slices,
    the forward gathers the stack whole once and runs every slice, and the
    gradient of this rank's slices is the whole stack's (sliced). Without
    ``world_split``, the single-process twin."""
    from torch import nn

    from deepl_project_tpu_torch.ops import stack as stack_mod
    from deepl_project_tpu_torch.ops.stack import BlockStack
    from deepl_project_tpu_torch.parallel import create_mesh, shard_params

    class Block(nn.Module):
        def __init__(self, device=None):
            super().__init__()
            self.lin = nn.Linear(2, 4, bias=False, device=device)

        def forward(self, x):
            return x + torch.tanh(self.lin(x))[..., :2]

    stack = BlockStack(Block, {}, 8, device="cpu")
    with torch.no_grad():
        stack.template.lin.weight.copy_(
            torch.from_numpy(np.random.default_rng(0).standard_normal((8, 4, 2))
                             .astype(np.float32)))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 2)).astype(np.float32))
    placement = None
    if world_split:
        placement = shard_params(create_mesh(model=dist.get_world_size()), stack, "fsdp",
                                 fsdp_min_size=16, prefix="s.")
    gathers = []
    gather = stack_mod.gather_from_group
    stack_mod.gather_from_group = lambda *a, **kw: gathers.append(1) or gather(*a, **kw)
    try:
        w = stack.template.lin.weight
        y = stack(x)
        (g,) = torch.autograd.grad(y.square().sum(), [w])
    finally:
        stack_mod.gather_from_group = gather
    return {"y": y.detach(), "grad": g, "held": tuple(w.shape), "gathers": len(gathers),
            "dim": None if placement is None else placement.dim("s.scan.block.lin.weight")}


def fit(mode: str, model_size: int, out_dir: str, data: list, model_kw: dict) -> dict:
    """Trainer.fit of the micro model built with ``model_kw`` (2 steps, a
    checkpoint under ``out_dir``) under a mesh of ``model_size`` and
    ``mode``; the parameters whole."""
    from deepl_project_tpu_torch.parallel import sharding
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.training.train_step import named_trainables

    sharding.FSDP_MIN_SIZE = J.FSDP_MIN
    tc = TrainerConfig(batch_size=data[0].shape[0], accum_steps=1, warmup_steps=1,
                       num_epochs=1, steps_per_epoch=len(data), log_every=1,
                       resolution=J.RES, output_dir=out_dir, weights=J._weights(),
                       save_every_epochs=1, seed=J.SEED, mesh_model=model_size,
                       param_sharding=mode)
    trainer = Trainer(J.micro_config(**model_kw), tc, device="cpu")
    state = trainer.fit(iter(data), state=trainer.create_state())
    return {"params": J._whole(trainer.placement, named_trainables(state.model)),
            "step": state.step}


def resume(mode: str, model_size: int, out_dir: str, model_kw: dict) -> dict:
    """A Trainer of ``model_kw`` under ``mode`` resumed from ``out_dir``'s
    checkpoint (written in either layout): its step and parameters whole."""
    from deepl_project_tpu_torch.parallel import sharding
    from deepl_project_tpu_torch.training import Trainer, TrainerConfig
    from deepl_project_tpu_torch.training.train_step import named_trainables

    sharding.FSDP_MIN_SIZE = J.FSDP_MIN
    tc = TrainerConfig(batch_size=4, warmup_steps=1, resolution=J.RES, output_dir=out_dir,
                       weights=J._weights(), seed=J.SEED, mesh_model=model_size,
                       param_sharding=mode)
    trainer = Trainer(J.micro_config(**model_kw), tc, device="cpu")
    state, _ = trainer.maybe_resume(trainer.create_state())
    return {"params": J._whole(trainer.placement, named_trainables(state.model)),
            "step": state.step}


def forward_tensor(model_size: int, batch: np.ndarray, model_kw: dict) -> dict:
    """The no-grad forward at attention 'auto' under 'tensor': recon and mu,
    the attention routes and the count of modules handed the model group."""
    from deepl_project_tpu_torch.ops import attention
    from deepl_project_tpu_torch.parallel import shard_params

    model = J.build_model(attention_impl="auto", **model_kw)
    shard_params(J._mesh(model_size), model, "tensor")
    attention.reset_route_counts()
    with torch.no_grad():
        recon, mu, _ = model(torch.as_tensor(batch).permute(0, 3, 1, 2))
    grouped = sum(getattr(m, "model_group", None) is not None for m in model.modules())
    return {"recon": recon, "mu": mu, "routes": attention.route_counts(), "grouped": grouped}
