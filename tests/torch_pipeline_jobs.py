"""Rank jobs of the port's pipeline and expert-parallel tests
(tests/test_torch_pipeline.py, tests/test_torch_expert_parallel.py),
JAX-free: the ranks import only torch, numpy and deepl_project_tpu_torch;
torch_parallel_jobs.RankPool runs them. Every job returns its rank's
results (whole tensors where the test compares them) and the world size it
ran on, so each test can assert that more than one rank took part.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


GRID, CH = 8, 8  # the dry run's phase-5 latents: 8x8x8
# optax.adamw(1e-3), the JAX tests' optimizer, as make_optimizer's arguments.
ADAMW = dict(learning_rate=1e-3, warmup_steps=0, b2=0.999, weight_decay=1e-4,
             max_grad_norm=float("inf"))


def dit_inputs(b: int = 8, seed: int = 1):
    """(z [B, GRID, GRID, CH], t [B], labels [B] in [0, 10)) as numpy."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, GRID, GRID, CH)).astype(np.float32)
    t = rng.uniform(size=b).astype(np.float32)
    y = rng.integers(0, 10, b).astype(np.int32)
    return z, t, y


def check_updated(got: dict, want: dict, grads: dict, lr: float = 1e-3) -> None:
    """Updated parameters within rtol 3e-4 / atol 3e-5 of JAX's; an entry
    whose JAX gradient lies within 1e-5 of its tensor's largest (Adam's
    first step moves it by lr g / (|g| + eps), whose size two rounding
    orders can change by up to lr; tests/torch_parallel_jobs.check_params'
    rule) within 2 lr."""
    for k, v in want.items():
        g = np.abs(grads[k])
        tiny = g <= 1e-5 * g.max()
        err = np.abs(got[k].numpy() - v)
        assert (err[~tiny] <= 3e-5 + 3e-4 * np.abs(v[~tiny])).all(), (k, err[~tiny].max())
        assert (err[tiny] <= 2 * lr).all(), k


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# -- pipeline_apply on the conditioned residual MLP block of tests/test_pipeline.py
def mlp_block(p: dict, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return x + torch.tanh(x @ p["w1"] + cond[:, None, :]) @ p["w2"]


def mlp_pipeline(params: dict, x: np.ndarray, cond: np.ndarray, micro: int,
                 grads: bool) -> dict:
    """pipeline_apply over every rank (one stage each) of the MLP stack whose
    stacked numpy ``params`` are [depth, d, d], each stage handed its
    slices (as JAX's shard_map hands it its part): y, and with ``grads``
    the gradients of mean(y^2) in x, cond and this stage's blocks (by
    slot), taken in the whole stack."""
    from deepl_project_tpu_torch.parallel import pipeline_apply, stage_range

    group = dist.group.WORLD
    depth = params["w1"].shape[0]
    mine = stage_range(depth, dist.get_rank(group), dist.get_world_size(group))
    stacked = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    part = {k: v[mine.start:mine.stop] for k, v in stacked.items()}
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(cond, requires_grad=True)
    y = pipeline_apply(mlp_block, part, xt, ct, group=group, num_microbatches=micro)
    out = {"world": _world(), "y": y.detach()}
    if grads:
        got = torch.autograd.grad(y.square().mean(), [xt, ct, stacked["w1"], stacked["w2"]])
        out["dx"], out["dcond"] = got[0], got[1]
        out["blocks"] = {(i, k): g[i] for i in mine for k, g in zip(("w1", "w2"), got[2:])}
        # The other stages' slices get no gradient here.
        out["others_zero"] = all(bool((g[i] == 0).all()) for i in range(depth)
                                 if i not in mine for g in got[2:])
    return out


def refusals() -> dict:
    """A pipeline's refusals on three ranks: depth 8 over 3 stages
    (``stage_range``, which picks a stage's slices), and batch 8 in 3
    microbatches (``pipeline_apply``; depth 6)."""
    from deepl_project_tpu_torch.parallel import pipeline_apply, stage_range

    group = dist.group.WORLD
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    x, c = torch.zeros(8, 4, 2), torch.zeros(8, 2)
    out = {"world": _world()}
    for key, depth, micro in (("depth", 8, 4), ("batch", 6, 3)):
        try:
            mine = stage_range(depth, rank, size)
            pipeline_apply(lambda p, x, c: x, {"w": torch.zeros(len(mine), 1)}, x, c,
                           group=group, num_microbatches=micro)
        except ValueError as e:
            out[key] = str(e)
    return out


# -- the DiT ---------------------------------------------------------------
def _dit(cfg_kw: dict, sd: dict | None, placement=None, seed: int | None = None):
    from deepl_project_tpu_torch.models import DiT, DiTConfig, create_dit

    from deepl_project_tpu_torch.utils.convert import load_state_dict

    cfg = DiTConfig(**cfg_kw)
    if sd is None:
        return create_dit(cfg, 8, device="cpu", seed=seed, placement=placement)
    model = load_state_dict(DiT(cfg, 8), sd)  # either layout into the model's
    return model if placement is None else placement.shard(model)


def _slices(model) -> tuple | None:
    """The (first, stop) slices of the stack a stacked DiT holds."""
    if not model.config.stacked:
        return None
    return (model.blocks.held.start, model.blocks.held.stop)


def _placement(data: int, pipe: int, expert: int):
    from deepl_project_tpu_torch.parallel import PipelinePlacement, create_dit_mesh

    return PipelinePlacement(create_dit_mesh(data, pipe, expert))


def dit_forward(cfg_kw: dict, sd: dict, z, t, y, pipe: int, expert: int = 1) -> dict:
    """The DiT's no-grad forward of the whole batch on every rank under a
    (1, pipe, expert) mesh's ambient axes."""
    from deepl_project_tpu_torch.parallel import use_axes

    pl = _placement(1, pipe, expert)
    model = _dit(cfg_kw, sd, pl)
    with torch.no_grad(), use_axes(pl.mesh):
        v = model(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y).long())
    return {"world": _world(), "v": v, "slices": _slices(model)}


def dit_step(cfg_kw: dict, sd: dict, z0, labels, t, noise, mesh: tuple | None,
             opt_kw: dict) -> dict:
    """One make_dit_train_step step from the whole weights ``sd`` on the
    global batch (z0, labels and JAX's t and noise, numpy): on one process
    for ``mesh`` None, else under a PipelinePlacement of the (data, pipe,
    expert) dims ``mesh``, each rank its rows. Metrics, the updated
    parameters and the optimizer state, whole; the microbatch runs."""
    from deepl_project_tpu_torch.parallel import shard_batch
    from deepl_project_tpu_torch.parallel.pipeline import reset_run_counts, run_counts
    from deepl_project_tpu_torch.training import TrainState, make_dit_train_step, make_optimizer
    from deepl_project_tpu_torch.training.train_step import named_trainables

    pl = None if mesh is None else _placement(*mesh)
    model = _dit(cfg_kw, sd, pl)
    named = named_trainables(model)
    opt = make_optimizer(named, placement=pl, **opt_kw)
    grads, apply = {}, opt.step

    def step(gs):  # the gradients the update sees (averaged, before the clip)
        grads.update((n, g.clone()) for (n, _), g in zip(named, gs))
        return apply(gs)

    opt.step = step
    rows = (lambda a: torch.as_tensor(a)) if pl is None else (
        lambda a: torch.as_tensor(shard_batch(pl.mesh, a)))
    reset_run_counts()
    m = make_dit_train_step(model, placement=pl)(TrainState(0, model, opt), rows(z0),
                                                 rows(labels).long(), rows(t), rows(noise))
    whole = (lambda d: d) if pl is None else pl.full_named
    state = opt.state_dict()
    return {"world": _world(), "metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.detach().clone() for k, v in whole(dict(named)).items()},
            "grads": whole(grads), "opt": {k: v for k, v in state.items() if isinstance(v, dict)},
            "runs": run_counts(), "held": {n: tuple(p.shape) for n, p in named},
            "slices": _slices(model)}


def staged_init(cfg_kw: dict, data: int, pipe: int, expert: int) -> dict:
    """create_dit from a seed under a placement: this rank's parameters
    against the whole model's from the same seed (sliced), the names it
    holds, and a whole checkpoint round trip through full_state / load_full
    into a fresh placed model."""
    from deepl_project_tpu_torch.training.train_step import named_trainables

    pl = _placement(data, pipe, expert)
    whole = dict(_dit(cfg_kw, None, seed=3).named_parameters())
    part = _dit(cfg_kw, None, pl, seed=3)
    mine = pl.local_named(whole, list(dict(part.named_parameters())))
    equal = all(torch.equal(p, mine[n]) for n, p in part.named_parameters())
    full = pl.full_state(named_trainables(part))
    fresh = _dit(cfg_kw, None, _placement(data, pipe, expert), seed=9)
    pl.load_full(named_trainables(fresh), full)
    return {"world": _world(), "equal": equal, "slices": _slices(part),
            "shapes": {n: tuple(p.shape) for n, p in part.named_parameters()},
            "full_equal": set(full) == set(whole) and all(torch.equal(full[n], whole[n])
                                                          for n in whole),
            "round_trip": all(torch.equal(p, q) for p, q in
                              zip(part.parameters(), fresh.parameters()))}


# -- expert parallelism ------------------------------------------------------
def switch_ffn(sd: dict, x: np.ndarray, e: int, cap: float, g: np.ndarray) -> dict:
    """The SwitchFFN [D=x.shape[-1], H] with ``e`` experts over an expert
    group of every rank (data 1, pipe 1): its output, and the gradients of
    <out, g> in x and the router and (gathered) the experts."""
    from deepl_project_tpu_torch.ops.moe import SwitchFFN, collect_aux_losses
    from deepl_project_tpu_torch.parallel import use_axes

    d, hidden = x.shape[-1], sd["experts.up.weight"].shape[1]
    ffn = SwitchFFN(d, hidden, e, cap, True, "expert")
    ffn.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    pl = _placement(1, 1, _world())
    ffn.hold_experts(pl.expert_rank, pl.expert_size)
    xt = torch.tensor(x, requires_grad=True)
    with use_axes(pl.mesh):
        out = ffn(xt)
    aux = collect_aux_losses(ffn)
    params = dict(ffn.named_parameters())
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), [xt] + list(params.values()))
    grads = {n: pl.gather(gr, 0 if n.startswith("experts.") else None)
             for n, gr in zip(params, got[1:])}
    return {"world": _world(), "out": out.detach(), "aux": float(aux.detach()), "dx": got[0],
            "grads": grads, "held": ffn.held}


def dryrun_phase5(data: int, pipe: int, expert: int) -> dict:
    from deepl_project_tpu_torch.parallel.dryrun import dit_phase

    return {"world": _world(), **dit_phase(data, pipe, expert, torch.device("cpu"))}


def bf16_forward(cfg_kw: dict, sd: dict, z, t, y, mesh: tuple) -> dict:
    """The bf16 DiT's no-grad forward under a (data, pipe, expert) mesh, the
    whole batch on every rank (gloo's bf16 transfers, broadcast and
    all-gather), and its step's loss and grad norm."""
    from deepl_project_tpu_torch.parallel import use_axes
    from deepl_project_tpu_torch.training import TrainState, make_dit_train_step, make_optimizer
    from deepl_project_tpu_torch.training.train_step import named_trainables

    pl = None if mesh is None else _placement(*mesh)
    model = _dit(cfg_kw, sd, pl)
    args = torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y).long()
    with torch.no_grad(), use_axes(None if pl is None else pl.mesh):
        v = model(*args)
    state = TrainState(0, model, make_optimizer(named_trainables(model), placement=pl))
    m = make_dit_train_step(model, placement=pl)(state, args[0], args[2], args[1], args[0])
    return {"world": _world(), "v": v, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"])}
