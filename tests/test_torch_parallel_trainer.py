"""The port's parallel training through its entry points on gloo ranks,
on the CPU (harness: tests/torch_parallel_jobs.py; one pool of rank
processes for the file): the GAN step, checkpoints that cross placements
and process counts, ``cli.train --mesh_model 2 --param_sharding tensor``
as torchrun starts it, the mesh's coordinates against the JAX package's
device layout, and the subset mesh (a global batch that does not split over
the ranks) against the JAX trainer's, through Trainer.fit and cli.train.

Tolerances as in tests/test_torch_parallel_steps.py: losses 1e-6
relative, parameters 1e-5 of the largest |parameter| (a parameter whose
gradient is rounding noise, 2 x steps x lr); the adaptive GAN weight 1e-5
relative; the disc-floor decisions equal; checkpoints restore bit-equal.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import torch_parallel_jobs as J
from deepl_project_tpu.parallel import create_mesh as jax_create_mesh
from deepl_project_tpu_torch.parallel import data_axis_size

torch.set_num_threads(1)
DATA = J.batches(2, 4)


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("mode, world", [("replicate", 2), ("tensor", 4)])
def test_gan_step_matches_single_process(pool, tmp_path, mode, world):
    """Two GAN steps (adaptive weight, R1, the disc loss floor at 2.0) at
    data 2 (x model 2 under tensor): the generator's gradients, the losses,
    the adaptive weight from the global last-layer gradients, the floor's
    decision on the global disc loss (blocked, then through), and the
    generator's and discriminator's parameters."""
    ref = J.gan(None, 1, DATA)
    assert [m["disc_update_scale"] for m in ref["metrics"]] == [0.0, 1.0]
    got = pool.run(J.gan, world, tmp_path, mode, world // 2, DATA)
    for r in got:
        J.check_grads(ref["grads"], r["grads"])
        for a, b in zip(ref["metrics"], r["metrics"], strict=True):
            for k in ("total", "disc_loss", "disc_r1", "gan"):
                assert abs(a[k] - b[k]) <= 1e-6 * abs(a[k]), (k, a[k], b[k])
            w = a["adaptive_gan_weight"]
            assert abs(w - b["adaptive_gan_weight"]) <= 1e-5 * w
            assert a["disc_update_scale"] == b["disc_update_scale"]
        J.check_params(ref["grads"], ref["params"], r["params"], 2)
        err = max(float((v - r["disc"][k]).abs().max()) for k, v in ref["disc"].items())
        assert err <= J.PARAM_TOL * J._max(ref["disc"]), err


def test_bf16_gan_step_lies_within_rounding_of_one_process(pool, tmp_path):
    """The GAN step in bf16 at data 2 against one process in bf16: each
    rank's adaptive weight and loss lie no farther from it than twice one
    process's bf16 step lies from its fp32 step. The ranks round other
    partial sums than one process does, so bf16 rounding alone moves them
    by about that much; in fp32 the two agree to 1e-5 (above)."""
    f32, b16 = (J.gan(None, 1, DATA, steps=1, dtype=dt)["metrics"][0]
                for dt in ("float32", "bfloat16"))
    got = pool.run(J.gan, 2, tmp_path, "replicate", 1, DATA, 1, 2.0, "bfloat16")
    for k in ("adaptive_gan_weight", "total"):
        own = abs(b16[k] - f32[k]) / abs(f32[k])
        assert own > 1e-4, (k, own)  # bf16 does move it
        for r in got:
            gap = abs(r["metrics"][0][k] - b16[k]) / abs(b16[k])
            print(f"{k}: ranks vs one process in bf16 {gap:.2e}, one process bf16 vs fp32 "
                  f"{own:.2e}")
            assert gap <= 2 * own, (k, gap, own)


@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_checkpoint_saved_under_sharding_resumes_in_one_process(pool, tmp_path, mode):
    """Trainer.fit on model=2 writes one whole checkpoint (rank 0); a single
    process resumes it: parameters, EMA and optimizer moments equal the
    ranks' gathered state, bit for bit."""
    out = str(tmp_path / "run")
    ranks = pool.run(J.fit, 2, tmp_path, mode, 2, out, DATA)
    single = J.fit("replicate", 1, out, DATA, resume_only=True)
    assert single["step"] == ranks[0]["step"] == 2
    for key in ("params", "ema"):
        for k, v in ranks[0][key].items():
            assert torch.equal(v, single[key][k]), (key, k)
    for k, v in ranks[0]["optimizer"]["nu"].items():
        assert torch.equal(v, single["optimizer"]["nu"][k]), k


@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_single_process_checkpoint_resumes_under_sharding(pool, tmp_path, mode):
    """The reverse: a single process's checkpoint restored on data=1 x
    model=2 gives every rank its slices of the same state."""
    out = str(tmp_path / "run")
    single = J.fit("replicate", 1, out, DATA)
    for r in pool.run(J.fit, 2, tmp_path, mode, 2, out, DATA, True):
        assert r["step"] == single["step"] == 2
        for key in ("params", "ema"):
            for k, v in single[key].items():
                assert torch.equal(v, r[key][k]), (key, k)
        for k, v in single["optimizer"]["mu"].items():
            assert torch.equal(v, r["optimizer"]["mu"][k]), k


def test_train_cli_tensor_parallel_under_torchrun(pool, tmp_path):
    """cli.train --mesh_model 2 --param_sharding tensor on two gloo ranks
    (RANK / WORLD_SIZE / LOCAL_RANK as torchrun sets them), two steps: no
    'not yet ported', one history and one checkpoint, from rank 0."""
    out = tmp_path / "cli"
    argv = ["--device", "cpu", "--data", "shapes", "--resolution", "32", "--batch_size", "4",
            "--num_epochs", "1", "--steps_per_epoch", "2", "--log_every", "1",
            "--lpips_weight", "0", "--warmup_steps", "1", "--save_every_epochs", "1",
            "--mesh_model", "2", "--param_sharding", "tensor", "--output_dir", str(out)]
    assert pool.run(J.train_cli, 2, tmp_path, argv, 2) == [True, True]
    rows = [json.loads(line) for line in open(out / "history.jsonl")]
    assert [r["step"] for r in rows if r["kind"] == "train"] == [1, 2]
    assert np.isfinite([r["total"] for r in rows]).all()
    assert sorted(os.listdir(out / "checkpoints")) == ["ckpt_000000002.pt", "config.json"]
    assert json.load(open(out / "run_args.json"))["args"]["param_sharding"] == "tensor"


@pytest.mark.parametrize("data, model", [(4, 1), (2, 2), (1, 4)])
def test_create_mesh_coordinates_match_jax(pool, tmp_path, data, model):
    """Rank i's (data, context, model) coordinate is device i's place in the
    JAX package's create_mesh over the first 4 devices."""
    mesh = jax_create_mesh(data=data, model=model, devices=jax.devices()[:4])
    where = {int(d.id): tuple(int(i) for i in idx)
             for idx, d in np.ndenumerate(mesh.devices)}
    ids = [int(d.id) for d in jax.devices()[:4]]
    for rank, coord in pool.run(J.mesh_coordinates, 4, tmp_path, data, model):
        assert coord == where[ids[rank]], (rank, coord)


def test_subset_mesh_rule_is_a_refusal_naming_the_divisor():
    """The data axis is the JAX trainer's: world / model where the global
    batch splits over it, else gcd(batch, devices / model) (its subset
    mesh); a world that model groups do not split is still refused, naming
    the divisor."""
    assert data_axis_size(8, 4, 2) == 2
    assert data_axis_size(6, 4, 1) == 2
    assert data_axis_size(6, 8, 2) == 2
    assert data_axis_size(3, 2, 1) == 1
    assert data_axis_size(6, 8, 1) == math.gcd(6, len(jax.devices()))
    with pytest.raises(ValueError, match="not a multiple of mesh_model"):
        data_axis_size(8, 3, 2)


# -- the subset mesh against the JAX trainer's ---------------------------------------
SUBSET = J.batches(1, 6, seed=5)  # a global batch of 6 on 4 ranks, model 1


@pytest.fixture(scope="module")
def jax_subset_step():
    """The JAX Trainer at batch 6 on its 8 devices (a subset mesh of
    gcd(6, 8) = 2 data devices) and one step of it from the micro model's
    weights (noise pinned out: the logvar bias at -200, clipped to -80):
    (its mesh's axes, its metrics, the weights as a JAX tree)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from deepl_project_tpu import get_config as jax_get_config
    from deepl_project_tpu.losses.vae_loss import LossWeights as JaxLossWeights
    from deepl_project_tpu.parallel import batch_sharding
    from deepl_project_tpu.training.train_step import init_train_state
    from deepl_project_tpu.training.trainer import Trainer as JaxTrainer
    from deepl_project_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
    from deepl_project_tpu.utils.convert import torch_state_dict_to_params

    micro = {**J.MICRO, "logvar_clip": (-80.0, 20.0)}
    sd = {k: v.numpy() for k, v in J.build_model(**micro).state_dict().items()}
    sd["conv_logvar.bias"] = np.full_like(sd["conv_logvar.bias"], -200.0)
    jcfg = jax_get_config(J.VARIANT, **micro)
    params = torch_state_dict_to_params(sd, jcfg)
    jt = JaxTrainer(jcfg, JaxTrainerConfig(
        batch_size=6, warmup_steps=1, resolution=J.RES, seed=J.SEED, use_lpips=False,
        output_dir="unused", weights=JaxLossWeights(l1=1.0, lpips=0.0, kl=1e-2, vf=0.0,
                                                    gan=0.0)))
    state = jax.device_put(init_train_state({"model": params}, jt.tx),
                           NamedSharding(jt.mesh, PartitionSpec()))
    batch = jax.device_put(SUBSET[0], batch_sharding(jt.mesh))
    _, m = jt.step_fn(state, batch, jax.random.PRNGKey(J.SEED))
    return dict(jt.mesh.shape), {k: float(v) for k, v in m.items()}, params


def test_subset_mesh_step_matches_jax(pool, tmp_path, jax_subset_step):
    """Trainer.fit at global batch 6 on 4 ranks (model 1) takes the JAX
    trainer's subset mesh, 2 data ranks (3 rows each), and its step from
    the same converted weights: loss and grad norm within 1e-6 / 1e-5 of
    one process's port (the parallel steps' bars) and within 1e-4 of the
    JAX trainer's step (the bar of tests/test_torch_adafactor.py's
    Trainer.fit against JAX's; fp32 sums in other orders, measured: the
    grad norm 1.2e-5 apart).
    Ranks 2-3 are left out: they return from fit, take no step and write
    nothing; rank 0 alone writes the history and the checkpoint."""
    jmesh, want, params = jax_subset_step
    assert jmesh["data"] == 2 and jmesh["model"] == 1
    out = str(tmp_path / "subset")
    single = J.subset_fit(out, SUBSET, params)
    got = pool.run(J.subset_fit, 4, tmp_path, out, SUBSET, params)
    assert [r["outside"] for r in got] == [False, False, True, True]
    assert [r["data"] for r in got] == [jmesh["data"]] * 2 + [None] * 2
    assert [r["step"] for r in got] == [1, 1, None, None]
    # (tb/: TensorBoard's event file, where tensorboardX is installed.)
    assert [f for f in got[0]["files"] if not f.startswith("tb/")] == [
        "checkpoints/ckpt_000000001.pt", "checkpoints/config.json", "history.jsonl"]
    assert got[1]["files"] == got[2]["files"] == got[3]["files"] == []
    (row,) = got[0]["rows"]
    (ref,) = single["rows"]
    assert abs(row["total"] - ref["total"]) <= 1e-6 * abs(ref["total"]), (row, ref)
    assert abs(row["grad_norm"] - ref["grad_norm"]) <= 1e-5 * ref["grad_norm"], (row, ref)
    for k in ("total", "l1", "kl", "grad_norm"):
        np.testing.assert_allclose(row[k], want[k], rtol=1e-4, err_msg=k)


def test_train_cli_on_a_subset_mesh_under_torchrun(pool, tmp_path):
    """cli.train --batch_size 6 on four gloo ranks as torchrun starts them:
    ranks 0-1 train (3 rows each), ranks 2-3 wait and return; one history
    and one checkpoint, rank 0's."""
    out = tmp_path / "cli"
    argv = ["--device", "cpu", "--data", "shapes", "--resolution", "32", "--batch_size", "6",
            "--num_epochs", "1", "--steps_per_epoch", "2", "--log_every", "1",
            "--lpips_weight", "0", "--warmup_steps", "1", "--save_every_epochs", "1",
            "--output_dir", str(out)]
    assert pool.run(J.train_cli, 4, tmp_path, argv, 4) == [True] * 4
    rows = [json.loads(line) for line in open(out / "history.jsonl")]
    assert [r["step"] for r in rows if r["kind"] == "train"] == [1, 2]
    assert np.isfinite([r["total"] for r in rows]).all()
    assert sorted(os.listdir(out / "checkpoints")) == ["ckpt_000000002.pt", "config.json"]
    assert set(os.listdir(out)) - {"tb"} == {"checkpoints", "history.jsonl", "run_args.json"}
