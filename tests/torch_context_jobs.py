"""Rank jobs of the port's context-parallel tests
(tests/test_torch_ring_attention.py, tests/test_torch_context_parallel.py,
tests/test_torch_context_terms.py), JAX-free: the ranks import only torch, deepl_project_tpu_torch and
torch_parallel_jobs (whose RankPool runs them and whose micro model they
build). Each job returns whole tensors (gathered over the ranks) so the test
holds them to the JAX package's single-device results.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import torch_parallel_jobs as J


def _mesh(data: int, context: int, model: int = 1):
    from deepl_project_tpu_torch.parallel import create_mesh

    return create_mesh(data=data, context=context, model=model)


def _chunk(x: np.ndarray, dim: int, group) -> torch.Tensor:
    from deepl_project_tpu_torch.parallel.context import split_rows

    return split_rows(torch.as_tensor(x), dist.get_rank(group), dist.get_world_size(group), dim)


def _maxabs(t: torch.Tensor) -> float:
    """max |t|, 0 for a rank that holds no rows."""
    return float(t.detach().abs().max()) if t.numel() else 0.0


def _split(rows: int, group) -> list[tuple[int, int]]:
    from deepl_project_tpu_torch.parallel.context import row_split

    return row_split(rows, dist.get_world_size(group))


def _cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` along ``dim``, the ranks' parts equal or not (an
    uneven row split)."""
    from deepl_project_tpu_torch.parallel.collectives import all_gather_uneven, part_sizes

    t = t.detach()
    return all_gather_uneven(t, dim, group, part_sizes(t.shape[dim], group, t.device))


def whole_rows(mesh, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole batch from every rank's rows: along ``dim`` over the
    context group, then along the batch over the data group."""
    t = _cat(t, dim, mesh.get_group("context"))
    return _cat(t, 0, mesh.get_group("data"))


def ring(q, k, v, do, scale: float, dtype: str) -> dict:
    """The ring over every rank on the token chunks of whole q, k, v
    [B, N, h, d] (numpy fp32, cast to ``dtype``): the output of
    ``ring_attention`` (plain partials on the CPU) and of
    ``ring_attention_reference``, and ``ring_attention``'s dq, dk, dv for the
    output gradient ``do``; each whole, with the ring steps counted."""
    from deepl_project_tpu_torch.parallel.ring_attention import (
        reset_step_counts, ring_attention, ring_attention_reference, step_counts)

    group = dist.group.WORLD
    dt = getattr(torch, dtype)
    local = [_chunk(t, 1, group).to(dt).requires_grad_(True) for t in (q, k, v)]
    sizes = [hi - lo for lo, hi in _split(q.shape[1], group)]
    reset_step_counts()
    out = ring_attention(*local, scale, group, sizes=sizes)
    grads = torch.autograd.grad(out, local, _chunk(do, 1, group).to(dt))
    ref = ring_attention_reference(*[t.detach() for t in local], scale, group, sizes=sizes)
    return {"out": _cat(out, 1, group), "ref": _cat(ref, 1, group),
            "grads": [_cat(g, 1, group) for g in grads], "steps": step_counts()}


def sequence_parallel(q, k, v, scale: float) -> torch.Tensor:
    """``sequence_parallel_attention`` on whole tensors over the data axis
    (every rank), the JAX test's call."""
    from deepl_project_tpu_torch.parallel import create_mesh, sequence_parallel_attention

    return sequence_parallel_attention(create_mesh(), *map(torch.as_tensor, (q, k, v)), scale)


def halo_adjoint(x, top: int, bottom: int, seed: int) -> tuple[float, float]:
    """<halo(x), g> and <x, halo^T(g)> summed over the ranks, x [B, C, H, W]
    split by rows (evenly or not) and g each rank's own draw of its padded
    block's shape."""
    from deepl_project_tpu_torch.parallel import exchange_rows
    from deepl_project_tpu_torch.parallel.collectives import all_reduce_sum

    group = dist.group.WORLD
    xl = _chunk(x, 2, group).double().requires_grad_(True)
    b, c, h, w = xl.shape
    gen = torch.Generator().manual_seed(seed + dist.get_rank(group))
    gl = torch.randn(b, c, top + h + bottom, w, generator=gen, dtype=torch.float64)
    y = exchange_rows(xl, top, bottom, group, x.shape[2])
    (gx,) = torch.autograd.grad(y, xl, gl)
    sums = torch.stack([(y * gl).sum(), (xl * gx).sum()]).detach()
    lhs, rhs = all_reduce_sum(sums, group).tolist()
    return lhs, rhs


def convs(x, up_x, seed: int) -> dict:
    """Each conv form under a context group of every rank against the whole
    map's conv sliced to this rank's rows (max |difference| and max
    |whole|, gathered): context_conv2d at stride 1 and 2, the fused up-conv
    (and the literal up path it must equal), the depthwise ConvFFN conv, and
    their input gradients."""
    from deepl_project_tpu_torch.ops.layers import Conv2d, init_conv_
    from deepl_project_tpu_torch.ops.resample import Downsample, Upsample
    from deepl_project_tpu_torch.parallel import context_parallel, create_mesh
    from deepl_project_tpu_torch.parallel.context import current, split_rows
    from deepl_project_tpu_torch.parallel.halo import pool2x2_rows

    mesh = create_mesh(data=1, context=dist.get_world_size())
    rank, size = dist.get_rank(), dist.get_world_size()
    gen = torch.Generator().manual_seed(seed)
    c = x.shape[1]
    mods = {"conv3x3": Conv2d(c, c, 3, padding=1), "conv3x3_stride2": Conv2d(c, 8, 3, 2, 1),
            "depthwise": Conv2d(c, c, 3, padding=1, groups=c),
            "shortcut1x1": Conv2d(c, 8, 1)}
    for m in mods.values():
        init_conv_(m, gen)
    up = Upsample(up_x.shape[1], 8)
    down = Downsample(c, 8)
    for m in (*up.modules(), *down.modules()):
        if isinstance(m, torch.nn.Conv2d):
            init_conv_(m, gen)

    def pool(t):
        state = current()
        return (torch.nn.functional.max_pool2d(t, 2, 2) if state is None
                else pool2x2_rows(t, state, x.shape[2]))

    out = {}
    cases = [(name, m, x) for name, m in mods.items()]
    cases += [("up_fused", up, up_x), ("up_literal", up, up_x), ("down_fused", down, x),
              ("down_literal", down, x), ("pool", pool, x)]
    for name, m, inp in cases:
        if m is up:
            up.fuse_main = up.fuse_dc = name == "up_fused"
        if m is down:
            down.fuse_dc = name == "down_fused"
        whole = torch.as_tensor(inp).requires_grad_(True)
        want = m(whole)
        (gw,) = torch.autograd.grad(want.square().sum(), whole)
        local = split_rows(torch.as_tensor(inp), rank, size, 2).requires_grad_(True)
        with context_parallel(mesh):
            got = m(local)
        (gl,) = torch.autograd.grad(got.square().sum(), local)
        err = _maxabs(got - split_rows(want.detach(), rank, size, 2))
        gerr = _maxabs(gl - split_rows(gw, rank, size, 2))
        out[name] = [err, float(want.abs().max()), gerr, float(gw.abs().max())]
    return out


def norm_and_rope(x, q) -> dict:
    """GroupNorm (and its input gradient) and RoPE under a context group of
    every rank against the single-process modules, sliced."""
    from deepl_project_tpu_torch.ops.norms import GroupNorm
    from deepl_project_tpu_torch.ops.rope import apply_rope2d
    from deepl_project_tpu_torch.parallel import context_parallel, create_mesh
    from deepl_project_tpu_torch.parallel.context import split_rows

    mesh = create_mesh(data=1, context=dist.get_world_size())
    rank, size = dist.get_rank(), dist.get_world_size()
    norm = GroupNorm(4, x.shape[1])
    with torch.no_grad():
        norm.weight.normal_(generator=torch.Generator().manual_seed(1))
        norm.bias.normal_(generator=torch.Generator().manual_seed(2))
    whole = torch.as_tensor(x).requires_grad_(True)
    want = norm(whole)
    w = torch.arange(want.numel(), dtype=want.dtype).reshape(want.shape).sin()
    (gw,) = torch.autograd.grad((want * w).sum(), whole)
    local = split_rows(torch.as_tensor(x), rank, size, 2).requires_grad_(True)
    with context_parallel(mesh):
        got = norm(local)
    (gl,) = torch.autograd.grad((got * split_rows(w, rank, size, 2)).sum(), local)
    # RoPE: q [B, H*W, heads, d] of an (H, W) grid; this rank's rows.
    b, n, h, d = q.shape
    height, width = x.shape[2], n // x.shape[2]
    rq = apply_rope2d(torch.as_tensor(q), height, width)
    mine = split_rows(torch.as_tensor(q).reshape(b, height, width, h, d), rank, size, 1)
    first = _split(height, dist.group.WORLD)[rank][0]
    lq = apply_rope2d(mine.reshape(b, mine.shape[1] * width, h, d), height, width,
                      first_row=first)
    want_q = split_rows(rq.reshape(b, height, width, h, d), rank, size, 1).reshape(lq.shape)
    return {"norm": _maxabs(got - split_rows(want.detach(), rank, size, 2)),
            "norm_grad": _maxabs(gl - split_rows(gw, rank, size, 2)),
            "rope": _maxabs(lq - want_q)}


def _context_model(model_kw: dict, state: dict | None):
    from deepl_project_tpu_torch.utils.convert import load_state_dict

    model = J.build_model(context_axis="context", **model_kw)
    if state is not None:  # either block layout, into the model's
        load_state_dict(model, {k: torch.as_tensor(v) for k, v in state.items()})
    return model


def forward(data: int, context: int, x, model_kw: dict, state: dict | None = None) -> dict:
    """The micro model (``context_axis='context'``) on a (data, context)
    mesh of every rank: this rank's rows of the [B, H, W, 3] batch ``x``,
    the no-grad forward decoding the mean; recon and mu whole, the routes."""
    from deepl_project_tpu_torch.ops import attention
    from deepl_project_tpu_torch.parallel import context_parallel, shard_rows

    mesh = _mesh(data, context)
    model = _context_model(model_kw, state)
    local = torch.as_tensor(shard_rows(mesh, x)).permute(0, 3, 1, 2)
    attention.reset_route_counts()
    with torch.no_grad(), context_parallel(mesh):
        recon, mu, _ = model(local)
    return {"recon": whole_rows(mesh, recon), "mu": whole_rows(mesh, mu),
            "routes": attention.route_counts()}


def step(data: int, context: int, model_size: int, accum: int, batch, noise: list,
         weights: dict, model_kw: dict, state: dict | None = None, lpips: dict | None = None,
         lr: float = 1e-2, mode: str = "replicate") -> dict:
    """One stage-1 step of the micro model under a (data, context, model)
    mesh of every rank (``model_size`` 0: one process, no mesh): the batch
    [B, H, W, 3] and the whole latent noise of each microbatch handed in;
    ``compute_grads`` then an SGD update p - lr g (the JAX test's
    ``optax.sgd``). The loss, the gradients and the updated parameters, whole."""
    from deepl_project_tpu_torch.parallel import shard_params, shard_rows
    from deepl_project_tpu_torch.training.train_step import (compute_grads, global_norm,
                                                             named_trainables)

    model = _context_model(model_kw, state)
    mesh = placement = None
    if model_size:
        mesh = _mesh(data, context, model_size)
        placement = shard_params(mesh, model, mode)
    named = named_trainables(model)
    local = torch.as_tensor(shard_rows(mesh, batch, accum))
    lp = None if lpips is None else {g: {n: torch.as_tensor(t) for n, t in leaves.items()}
                                     for g, leaves in lpips.items()}
    grads, metrics = compute_grads(model, local, J._weights(**weights), lp, accum_steps=accum,
                                   noise=[torch.as_tensor(e) for e in noise],
                                   placement=placement)
    grad_norm = float(global_norm(grads, placement, [n for n, _ in named]))
    with torch.no_grad():
        for (_, p), g in zip(named, grads):
            p.sub_(lr * g)
    names = [n for n, _ in named]
    whole = (lambda pairs: {n: t.detach().clone() for n, t in pairs}) if placement is None \
        else placement.full_state
    return {"loss": float(metrics["total"]), "grads": whole(zip(names, grads)),
            "params": whole(named), "mu_absmax": float(metrics["mu_absmax"]),
            "grad_norm": grad_norm}


def step_reference(*args, **kw) -> dict:
    return step(1, 1, 0, *args, **kw)


def refusals(batch) -> dict:
    """What context parallelism accepts and refuses on a context axis of
    every rank, by the message each raises ('accepted' where it runs): the
    VF term, the self-perceptual term, the GAN step, an int8 model run, a
    height whose maps split unevenly (24 rows at f = 8 over 2 ranks: 3 latent
    rows) and LPIPS on 8 rows a rank run; a height the downsample factor
    does not divide, a height the context size does not divide
    (``shard_rows``, JAX's ``device_put``) and a model without
    ``context_axis`` raise."""
    from deepl_project_tpu_torch.losses import LossWeights, make_self_perceptual
    from deepl_project_tpu_torch.losses.lpips import init_lpips_params, lpips
    from deepl_project_tpu_torch.models.discriminator import PatchDiscriminator
    from deepl_project_tpu_torch.parallel import context_parallel, shard_params, shard_rows
    from deepl_project_tpu_torch.training.train_step import (compute_grads, gan_generator_grads,
                                                             make_vf_proj_params)

    mesh = _mesh(1, dist.get_world_size())
    out = {}

    def message(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out[name] = str(e)
        else:
            out[name] = "accepted"

    model = _context_model({}, None)
    placement = shard_params(mesh, model, "replicate")
    vf_proj = make_vf_proj_params(4, 8, torch.Generator().manual_seed(7))
    local = torch.as_tensor(shard_rows(mesh, batch))
    message("vf", lambda: compute_grads(model, local, LossWeights(vf=0.1, lpips=0.0, gan=0.0),
                                        teacher_fn=J.stub_teacher, vf_proj=vf_proj,
                                        placement=placement))
    frozen = make_self_perceptual(_context_model({}, None))
    message("perceptual", lambda: compute_grads(model, local, LossWeights(gan=0.0),
                                                perceptual_fn=frozen, placement=placement))
    disc = PatchDiscriminator(base_channels=8, num_layers=2, dtype=torch.float32)
    message("gan", lambda: gan_generator_grads(model, disc, local, LossWeights(lpips=0.0),
                                               placement=placement))
    x = local.permute(0, 3, 1, 2)
    with context_parallel(mesh):
        message("int8", lambda: J.build_model(context_axis="context", quant="int8")(x))
        message("height", lambda: model(x[:, :, : x.shape[2] - 4]))
        message("height_f", lambda: model(x[:, :, : x.shape[2] - 2]))
        message("unset", lambda: J.build_model()(x))
        message("lpips", lambda: lpips(init_lpips_params(torch.Generator().manual_seed(0)),
                                       x[:, :, :8], x[:, :, :8]))
    message("height_c", lambda: shard_rows(mesh, batch[:, 1:]))
    return out


# -- the terms that read whole images, the GAN step and int8 -------------------
def term_step(data: int, context: int, batch, noise, weights: dict, model_kw: dict,
              state: dict, vf: dict | None = None, teacher: dict | None = None,
              perceptual: dict | None = None, lr: float = 1e-2) -> dict:
    """One stage-1 step of the micro model with the VF term (``teacher``:
    ``make_stub_teacher``'s arguments, its projection included; ``vf``: the
    projection's kernel and bias) or the self-perceptual term
    (``perceptual``: the frozen net's model_kw and state) under a (data,
    context) mesh of every rank: the batch and the whole latent noise handed
    in, ``compute_grads`` then p - lr g. The metrics, the grad norm, the
    gradients and the updated parameters, whole."""
    from deepl_project_tpu_torch.losses import make_self_perceptual
    from deepl_project_tpu_torch.losses.teachers import make_stub_teacher
    from deepl_project_tpu_torch.parallel import shard_params, shard_rows
    from deepl_project_tpu_torch.training.train_step import (VFProj, compute_grads,
                                                             global_norm, named_trainables)

    model = _context_model(model_kw, state)
    vf_proj = None
    if vf is not None:
        vf_proj = VFProj(*vf["kernel"].shape)
        vf_proj.load_state_dict({k: torch.as_tensor(v) for k, v in vf.items()})
    mesh = _mesh(data, context)
    placement = shard_params(mesh, model, "replicate")
    if vf_proj is not None:
        shard_params(mesh, vf_proj, "replicate", prefix="vf_proj.", placement=placement)
    tfn = None if teacher is None else make_stub_teacher(**teacher)
    pfn = None
    if perceptual is not None:
        pfn = make_self_perceptual(_context_model(perceptual["model_kw"], perceptual["state"]))
    named = named_trainables(model, vf_proj)
    names = [n for n, _ in named]
    local = torch.as_tensor(shard_rows(mesh, batch))
    grads, metrics = compute_grads(model, local, J._weights(**weights), teacher_fn=tfn,
                                   vf_proj=vf_proj, perceptual_fn=pfn, placement=placement,
                                   noise=[torch.as_tensor(noise)])
    norm = global_norm(grads, placement, names)
    with torch.no_grad():
        for (_, p), g in zip(named, grads):
            p.sub_(lr * g)

    def whole(pairs):
        return {n: t.numpy() for n, t in placement.full_state(pairs).items()}

    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grad_norm": float(norm),
            "grads": whole(zip(names, grads)), "params": whole(named)}


def perceptual_distance(data: int, context: int, recon, target, model_kw: dict,
                        state: dict) -> dict:
    """``make_self_perceptual``'s distances of this rank's rows of the NCHW
    batches ``recon`` and ``target`` under a (data, context) mesh of every
    rank, the frozen net built with ``context_axis``, and the gradient of
    their sum by ``recon``, taken after the context block is left (the
    checkpointed encoder's recompute must find the group again); both
    whole."""
    from deepl_project_tpu_torch.losses import make_self_perceptual
    from deepl_project_tpu_torch.parallel import context_parallel, shard_rows

    mesh = _mesh(data, context)
    fn = make_self_perceptual(_context_model(model_kw, state))
    local = torch.as_tensor(shard_rows(mesh, recon, dim=2)).requires_grad_(True)
    with context_parallel(mesh):
        d = fn(local, torch.as_tensor(shard_rows(mesh, target, dim=2)))
    d.sum().backward()
    return {"distances": _cat(d.detach(), 0, mesh.get_group("data")),
            "grad": whole_rows(mesh, local.grad)}


def gan_step(data: int, context: int, batch, gen: dict, vf: dict, disc: dict, teacher: dict,
             model_kw: dict, weights: dict, opts: dict, lr: float, clip: float) -> dict:
    """One ``make_gan_train_step`` of the micro model (its state ``gen``,
    the VF projection ``vf``), a PatchGAN (state ``disc``) and the stub
    teacher under a (data, context) mesh of every rank: AdamW at ``lr``
    clipped at ``clip`` for both (the harness of
    tests/gan_step_parity.py), the step's options ``opts``. The metrics and
    the updated generator (whole) and discriminator parameters (this
    rank's copy)."""
    from deepl_project_tpu_torch.losses.teachers import make_stub_teacher
    from deepl_project_tpu_torch.models.discriminator import PatchDiscriminator
    from deepl_project_tpu_torch.parallel import Placement, shard_params, shard_rows
    from deepl_project_tpu_torch.training.optim import make_optimizer
    from deepl_project_tpu_torch.training.train_step import (TrainState, VFProj,
                                                             make_gan_train_step,
                                                             named_trainables)

    model = _context_model(model_kw, gen)
    vf_proj = VFProj(*vf["kernel"].shape)
    vf_proj.load_state_dict({k: torch.as_tensor(v) for k, v in vf.items()})
    d = PatchDiscriminator(dtype=torch.float32)
    d.load_state_dict({k: torch.as_tensor(v) for k, v in disc.items()})
    mesh = _mesh(data, context)
    placement = shard_params(mesh, model, "replicate")
    shard_params(mesh, vf_proj, "replicate", prefix="vf_proj.", placement=placement)
    disc_placement = Placement(mesh)
    named = named_trainables(model, vf_proj)
    g = TrainState(0, model, make_optimizer(named, lr, 0, max_grad_norm=clip,
                                            placement=placement), vf_proj=vf_proj)
    ds = TrainState(0, d, make_optimizer(d.named_parameters(), lr, 0, max_grad_norm=clip,
                                         placement=disc_placement))
    step = make_gan_train_step(J._weights(**weights), seed=0,
                               teacher_fn=make_stub_teacher(**teacher), placement=placement,
                               disc_placement=disc_placement, **opts)
    metrics = step(g, ds, torch.as_tensor(shard_rows(mesh, batch)))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {n: t.numpy() for n, t in placement.full_state(named).items()},
            "disc": {n: p.detach().numpy().copy() for n, p in d.named_parameters()}}


def int8(data: int, context: int, calib: list, x, model_kw: dict, state: dict,
         scopes=("all", "resblock", "ffn")) -> dict:
    """Int8 post-training quantization under a (data, context) mesh of
    every rank (each data rank calibrating on its context rows of the whole
    calibration batches): ``calibrate_amax``
    of the micro float model on this rank's rows of ``calib``, then for
    each scope ``quantize_model`` and the no-grad forward of this rank's
    rows of ``x`` (decoding the mean). The amax, each scope's int8 state
    dict and its reconstruction, whole."""
    from deepl_project_tpu_torch.parallel import context_parallel, shard_rows
    from deepl_project_tpu_torch.parallel.context import split_rows
    from deepl_project_tpu_torch.quantize import calibrate_amax, quantize_model

    mesh = _mesh(data, context)
    crank = dist.get_rank(mesh.get_group("context"))
    model = _context_model(model_kw, state).eval()
    rows = [split_rows(torch.as_tensor(b), crank, context, 1) for b in calib]
    with context_parallel(mesh):
        amax = calibrate_amax(model, rows)
    out = {"amax": {m: {k: float(v) for k, v in s.items()} for m, s in amax.items()},
           "scopes": {}}
    local = torch.as_tensor(shard_rows(mesh, x)).permute(0, 3, 1, 2)
    for scope in scopes:
        with context_parallel(mesh):
            qmodel = quantize_model(model, rows, scope)
        with torch.no_grad(), context_parallel(mesh):
            recon = qmodel(local)[0]
        out["scopes"][scope] = {
            "state": {k: v.numpy() for k, v in qmodel.state_dict().items()},
            "recon": whole_rows(mesh, recon)}
    return out


def qconv_rows(x, kernel: int, seed: int) -> dict:
    """An int8 ``QConv2d`` (``kernel`` x ``kernel``, int8 weights and
    scales from a seeded float conv) under a context group of every rank,
    on this rank's rows of the bf16 map ``x``, against the whole map's int8
    conv sliced to those rows: whether they are bit-equal, the largest
    difference and the output's shape."""
    from deepl_project_tpu_torch.ops.quant import QConv2d, quantize_weight
    from deepl_project_tpu_torch.parallel import context_parallel
    from deepl_project_tpu_torch.parallel.context import split_rows

    mesh = _mesh(1, dist.get_world_size())
    rank, size = dist.get_rank(), dist.get_world_size()
    gen = torch.Generator().manual_seed(seed)
    cin, cout = x.shape[1], 8
    conv = QConv2d(cin, cout, kernel)
    wq, ws = quantize_weight(torch.randn(cout, kernel, kernel, cin, generator=gen), axis=0)
    with torch.no_grad():
        conv.kernel_q.copy_(wq)
        conv.kernel_scale.copy_(ws)
        conv.act_scale.fill_(0.02)
        conv.bias.copy_(torch.randn(cout, generator=gen))
    whole = torch.as_tensor(x).to(torch.bfloat16)
    with torch.no_grad():
        want = split_rows(conv(whole), rank, size, 2)
        with context_parallel(mesh):
            got = conv(split_rows(whole, rank, size, 2))
    return {"equal": bool(torch.equal(got, want)),
            "err": float((got.float() - want.float()).abs().max()),
            "shape": tuple(got.shape)}
