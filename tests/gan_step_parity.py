"""The parity harness of tests/test_torch_gan_step.py and
tests/test_torch_gan_disc_step.py: the port's GAN step
(``training.train_step.make_gan_train_step``) against the JAX package's
``make_gan_train_step``, on the CPU, over three steps.

A micro TransVAE (fp32; three stages, two CNN and one transformer) and the
default PatchGAN discriminator (fp32 here) on the same weights: the model's
drawn by the port and carried to JAX with ``torch_state_dict_to_params``,
the discriminator's drawn in JAX layout from a numpy seed and carried to the
port with ``load_jax_disc_params``. Batches of 32px images come from a
numpy seed. Before each step the port's states (parameters, optimizer
moments and counts, EMA shadow, both step counts) are set to JAX's; after
it, the metrics, the generator's and the discriminator's parameters and the
EMA shadow are compared. So every step is compared from one state, and
the comparison does not depend on how a trajectory amplifies rounding:
the hinge and leaky-ReLU kinks make the JAX step itself sensitive (at lr
1e-2, 1e-7 relative noise in its starting weights moves its own third
step's grad norm by ~0.6% and its fake-logit mean by ~13%; at this file's
lr 1e-3 by ~2e-6). ``PYTHONPATH=. python tests/gan_step_parity.py`` prints
each case's largest errors and that self-move, and (``bf16_gaps``) how far
each package's bf16 GAN step lies from its own fp32 step on each batch.

Set-up choices that keep the comparison exact:
- The latent noise is taken out: ``logvar_clip`` is (-80, 20) and
  ``conv_logvar``'s bias -200 in the shared weights, so logvar is pinned at
  -80 and the noise (another generator on each side) has a std of 4e-18.
  At the default clip (-30) the noise's std is 3e-7, which the
  discriminator's instance norms can amplify to the metrics' tolerance.
- Both optimizers clip at a global norm of 1e-8, so every clipped gradient
  entry lies below Adam's eps and the update is a smooth function of the
  gradient, a/(1 + |a|) times lr with a the entry over the global norm: a
  parameter whose gradient is rounding noise (a bias ahead of a norm) moves
  by rounding noise, where at the default clip Adam's first step would move
  it by +-lr at random. The optimizer itself is held to optax in
  tests/test_torch_training.py.

Tolerances (fp32 on both sides, sums in other orders): metrics 1e-4
relative (1e-6 absolute for terms that are 0 at a gate; measured <= 4e-6);
parameters and EMA 5e-4 x lr absolute, four fp32 steps at 1.0 (measured
<= 1.2e-4 x lr, one step at 1.0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
from deepl_project_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from deepl_project_tpu.training.optim import make_optimizer as jax_make_optimizer
from deepl_project_tpu.training.train_step import init_ema_train_state, init_train_state
from deepl_project_tpu.training.train_step import make_gan_train_step as jax_make_gan_train_step
from deepl_project_tpu.utils.convert import params_to_torch_state_dict as jax_to_sd
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import get_config
from deepl_project_tpu_torch.losses import LossWeights
from deepl_project_tpu_torch.models import PatchDiscriminator, TransVAE, init_weights
from deepl_project_tpu_torch.training import make_optimizer
from deepl_project_tpu_torch.training.train_step import TrainState, init_ema, make_gan_train_step
from deepl_project_tpu_torch.utils.convert import (disc_params_to_torch_state_dict,
                                                   load_jax_disc_params, load_jax_params)

torch.set_num_threads(2)
# Three stages (two CNN, one transformer): the JAX step's trace and compile,
# three model passes, cost ~10 s a case (four stages: ~15 s).
MICRO = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), latent_dim=4, head_dim=16,
             dtype="float32", attention_impl="auto_train", use_dc_path=False,
             logvar_clip=(-80.0, 20.0))
VARIANT = "tiny_f8d16"
RES, BATCH, STEPS = 32, 2, 3
LR, CLIP = 1e-3, 1e-8
RTOL, ATOL = 1e-4, 5e-4 * 1e-3
WEIGHTS = dict(l1=1.0, lpips=0.0, kl=1e-2, vf=0.0, gan=0.1)

# id: the step's options (``freeze`` goes to the generator's optimizer).
CASES = {
    "adaptive_off": {},
    "adaptive_on": dict(adaptive_weight=True, adaptive_max=1e4, ema_decay=0.9),
    "gate": dict(gan_warmup_steps=2, gan_ramp_steps=2),
    "freeze_encoder": dict(freeze=True),
    "r1": dict(r1_gamma=10.0),
    # One step of r1, then two with the floor at 100 (the trainer's defaults
    # run R1 and the floor together).
    "floor": dict(r1_gamma=10.0, disc_loss_floor=100.0),
}


def _check(worst: dict, kind: str, got, want, what: str) -> None:
    """Hold ``got`` to ``want`` (a metric: RTOL relative, 1e-6 absolute; a
    parameter: ATOL absolute) and keep the largest error of each kind
    (metrics relative, parameters in units of lr)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    if kind == "metric":
        worst[kind] = max(worst.get(kind, 0.0), float(err.max() / max(abs(want).max(), 1e-6)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6, err_msg=what)
    else:
        worst[kind] = max(worst.get(kind, 0.0), float(err.max() / LR))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


def make_shared(micro: dict = MICRO):
    """The shared weights (JAX trees, numpy leaves), the JAX modules, the
    batches, and one jitted JAX step per option set, made at first use."""
    src = TransVAE(get_config(VARIANT, **micro), device="cpu")
    init_weights(src, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    sd["conv_logvar.bias"] = np.full_like(sd["conv_logvar.bias"], -200.0)
    params = torch_state_dict_to_params(sd, jax_get_config(VARIANT, **micro))
    jd = JaxPatchDiscriminator(dtype=jnp.float32)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    rng = np.random.default_rng(11)
    dparams = jax.tree_util.tree_map_with_path(
        lambda p, s: ((0.02 if p[-1].key == "kernel" else 0.1) * rng.standard_normal(s.shape)
                      + (p[-1].key == "scale")).astype(np.float32), shapes["params"])
    batches = [rng.random((BATCH, RES, RES, 3), dtype=np.float32) for _ in range(STEPS)]
    return dict(params=params, dparams=dparams, batches=batches,
                model=JaxTransVAE(jax_get_config(VARIANT, **micro)), disc=jd, steps={},
                micro=micro)


def _jax_step(shared, opts):
    key = tuple(sorted(opts.items()))
    if key not in shared["steps"]:
        kw = {k: v for k, v in opts.items() if k != "freeze"}
        gen_tx = jax_make_optimizer(LR, 0, max_grad_norm=CLIP,
                                    freeze_encoder=opts.get("freeze", False))
        disc_tx = jax_make_optimizer(LR, 0, max_grad_norm=CLIP)
        shared["steps"][key] = (gen_tx, disc_tx, jax_make_gan_train_step(
            shared["model"], shared["disc"], gen_tx, disc_tx, JaxLossWeights(**WEIGHTS), **kw))
    return shared["steps"][key]


def _port_step(opts):
    return make_gan_train_step(LossWeights(**WEIGHTS), seed=0,
                               **{k: v for k, v in opts.items() if k != "freeze"})


def _names(path):
    return [getattr(p, "name", getattr(p, "key", None)) for p in path]


def _adam_state(opt_state, to_state_dict) -> dict:
    """The port's optimizer state_dict from an optax state (apply_if_finite
    around clip + adamw, optionally partitioned): moments by port name."""
    out = {"mu": {}, "nu": {}}
    for path, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = _names(path)
        moment = {"mu", "nu"} & set(names)
        if moment:
            node = out[moment.pop()]
            keys = names[names.index("model") + 1:]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.asarray(v)
        elif names[-1] in ("count", "notfinite_count", "total_notfinite", "last_finite"):
            out[names[-1]] = v.item()
    for m in ("mu", "nu"):
        out[m] = {k: torch.from_numpy(np.array(a)) for k, a in to_state_dict(out[m]).items()}
    return out


def _sync(port_g, port_d, gstate, dstate):
    """Set the port's states to the JAX states."""
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    load_jax_params(port_g.model, np_tree(gstate.params["model"]))
    port_g.optimizer.load_state_dict(_adam_state(gstate.opt_state, lambda t: jax_to_sd(t, None)))
    if port_g.ema is not None:
        shadow = jax_to_sd(np_tree(gstate.ema_params["model"]), None)
        for n, t in port_g.ema.items():
            t.copy_(torch.from_numpy(np.array(shadow[n])))
    load_jax_disc_params(port_d.model, np_tree(dstate.params["model"]))
    port_d.optimizer.load_state_dict(_adam_state(dstate.opt_state,
                                                 disc_params_to_torch_state_dict))
    port_g.step, port_d.step = int(gstate.step), int(dstate.step)


def run_case(case: str, shared: dict) -> dict:
    """Three steps of ``case`` on both sides, compared after each; returns
    the largest errors (metrics relative, parameters in units of lr)."""
    opts = CASES[case]
    plans = ([CASES["r1"]] + [opts] * (STEPS - 1) if case == "floor"
             else [opts] * STEPS)
    gen_tx, disc_tx, _ = _jax_step(shared, plans[0])
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731 (the step donates)
    ema = opts.get("ema_decay")
    gstate = (init_ema_train_state if ema else init_train_state)(
        {"model": copy(shared["params"])}, gen_tx)
    dstate = init_train_state({"model": copy(shared["dparams"])}, disc_tx)

    model = TransVAE(get_config(VARIANT, **shared["micro"]), device="cpu")
    disc = PatchDiscriminator(dtype=torch.float32, device="cpu")
    port_g = TrainState(0, model, make_optimizer(
        model.named_parameters(), LR, 0, max_grad_norm=CLIP,
        freeze_encoder=opts.get("freeze", False)), init_ema(model) if ema else None)
    port_d = TrainState(0, disc, make_optimizer(disc.named_parameters(), LR, 0,
                                                max_grad_norm=CLIP))
    scales, disc_before, worst = [], None, {}

    for i, (plan, batch) in enumerate(zip(plans, shared["batches"])):
        with torch.no_grad():
            _sync(port_g, port_d, gstate, dstate)
        if i == STEPS - 1:
            disc_before = {n: p.detach().clone() for n, p in disc.named_parameters()}
        encoder_before = {n: p.detach().clone() for n, p in model.named_parameters()
                          if n.startswith("encoder.")}
        gstate, dstate, jm = _jax_step(shared, plan)[2](gstate, dstate, jnp.asarray(batch),
                                                         jax.random.PRNGKey(0))
        pm = _port_step(plan)(port_g, port_d, torch.from_numpy(batch))
        scales.append(float(pm["gan_scale"]))
        assert port_g.step == int(gstate.step) == i + 1 == port_d.step == int(dstate.step)
        assert set(pm) == set(jm), (sorted(pm), sorted(jm))
        for k in jm:
            _check(worst, "metric", float(pm[k]), float(jm[k]), f"step {i} {k}")
        gen = jax_to_sd(jax.tree_util.tree_map(np.asarray, gstate.params["model"]), None)
        for n, p in model.named_parameters():
            _check(worst, "param", p.detach().numpy(), gen[n], f"step {i} {n}")
        dis = disc_params_to_torch_state_dict(dstate.params["model"])
        for n, p in disc.named_parameters():
            _check(worst, "param", p.detach().numpy(), dis[n], f"step {i} D {n}")
        if ema:
            shadow = jax_to_sd(jax.tree_util.tree_map(np.asarray, gstate.ema_params["model"]),
                               None)
            for n, t in port_g.ema.items():
                _check(worst, "param", t.numpy(), shadow[n], f"step {i} ema {n}")
        if opts.get("freeze"):
            for n, p in model.named_parameters():
                if n in encoder_before:
                    assert torch.equal(p, encoder_before[n]), n

    assert scales == ([0.0, 0.0, 0.5] if case == "gate" else [1.0] * STEPS)
    if case == "adaptive_on":
        assert 0 < float(pm["adaptive_gan_weight"]) < opts["adaptive_max"]
    if case == "floor":
        # The last step zeroed D's gradients; Adam's moments still moved it.
        assert float(pm["disc_update_scale"]) == 0.0
        assert any(not torch.equal(p, disc_before[n]) for n, p in disc.named_parameters())
    return worst


# The bf16 comparison's options: the adaptive weight unclamped and R1 (as
# chip_smoke.py's two-rank GAN step runs them).
BF16_OPTS = dict(adaptive_weight=True, adaptive_max=1e4, r1_gamma=10.0)
BF16_KEYS = ("grad_norm", "total", "adaptive_gan_weight", "disc_loss")


def _one_step(package: str, dtype: str, shared: dict, batch) -> dict:
    """One GAN step (BF16_OPTS) from the shared weights on ``batch`` with
    the model and the discriminator computing in ``dtype``, in the JAX
    package or the port; its metrics."""
    micro = {**shared["micro"], "dtype": dtype}
    if package == "jax":
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        gen_tx = jax_make_optimizer(LR, 0, max_grad_norm=CLIP)
        disc_tx = jax_make_optimizer(LR, 0, max_grad_norm=CLIP)
        step = jax_make_gan_train_step(JaxTransVAE(jax_get_config(VARIANT, **micro)),
                                       JaxPatchDiscriminator(dtype=jdt), gen_tx, disc_tx,
                                       JaxLossWeights(**WEIGHTS), **BF16_OPTS)
        copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731
        g = init_train_state({"model": copy(shared["params"])}, gen_tx)
        d = init_train_state({"model": copy(shared["dparams"])}, disc_tx)
        metrics = step(g, d, jnp.asarray(batch), jax.random.PRNGKey(0))[2]
    else:
        model = TransVAE(get_config(VARIANT, **micro), device="cpu")
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, shared["params"]))
        disc = PatchDiscriminator(dtype=getattr(torch, dtype), device="cpu")
        load_jax_disc_params(disc, jax.tree_util.tree_map(np.asarray, shared["dparams"]))
        g = TrainState(0, model, make_optimizer(model.named_parameters(), LR, 0,
                                                max_grad_norm=CLIP))
        d = TrainState(0, disc, make_optimizer(disc.named_parameters(), LR, 0,
                                               max_grad_norm=CLIP))
        metrics = _port_step(BF16_OPTS)(g, d, torch.from_numpy(batch))
    return {k: float(metrics[k]) for k in BF16_KEYS}


def bf16_gaps(shared: dict) -> list[dict]:
    """For each shared batch, one GAN step from the shared weights in bf16
    and in fp32 in each package: {package: {metric: |bf16 - fp32| / |fp32|}}
    -- how far each package's bf16 step lies from its own fp32 step."""
    rows = []
    for batch in shared["batches"]:
        row = {}
        for package in ("jax", "port"):
            f32, b16 = (_one_step(package, dt, shared, batch) for dt in ("float32", "bfloat16"))
            row[package] = {k: abs(b16[k] - f32[k]) / abs(f32[k]) for k in BF16_KEYS}
        rows.append(row)
    return rows


def jax_self_move(shared: dict, lr: float = LR, noise: float = 1e-7) -> list[dict]:
    """The JAX step against itself: per step of case adaptive_off at ``lr``,
    the relative move of grad_norm and disc_fake_mean when the starting
    weights carry ``noise`` relative noise (why the parity sets the states
    before each step instead of following two trajectories)."""
    gen_tx = jax_make_optimizer(lr, 0, max_grad_norm=CLIP)
    disc_tx = jax_make_optimizer(lr, 0, max_grad_norm=CLIP)
    step = jax_make_gan_train_step(shared["model"], shared["disc"], gen_tx, disc_tx,
                                   JaxLossWeights(**WEIGHTS))
    rng = np.random.default_rng(5)
    runs = []
    for eps in (0.0, noise):
        params = jax.tree_util.tree_map(
            lambda a: jnp.array(a * (1 + eps * rng.standard_normal(a.shape)).astype(np.float32)),
            shared["params"])
        g = init_train_state({"model": params}, gen_tx)
        d = init_train_state({"model": jax.tree_util.tree_map(jnp.array, shared["dparams"])},
                             disc_tx)
        metrics = []
        for batch in shared["batches"]:
            g, d, m = step(g, d, jnp.asarray(batch), jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append(metrics)
    return [{k: abs(a[k] - b[k]) / abs(a[k]) for k in ("grad_norm", "disc_fake_mean")}
            for a, b in zip(*runs)]


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gan_step_parity.py: the largest errors
    # of each case and JAX's own move under weight noise, per step.
    shared = make_shared()
    for case in CASES:
        print(case, run_case(case, shared))
    for lr in (LR, 1e-2):
        print(f"JAX self-move under 1e-7 weight noise, lr {lr}", jax_self_move(shared, lr))
    for i, row in enumerate(bf16_gaps(shared)):
        print(f"batch {i}: bf16 step against the same package's fp32 step", row)
