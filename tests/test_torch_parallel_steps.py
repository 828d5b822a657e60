"""The port's data-, FSDP- and tensor-parallel steps on 2 and 4 gloo ranks
against the single-process port, on the CPU (harness:
tests/torch_parallel_jobs.py; one pool of rank processes for the file).

The micro model in fp32 (2 heads at C=32 and 4 at C=64), global batches of
4 at 32px, two optimizer steps (AdamW, or Adafactor with the clip active),
the latent sampled: data=2 (replicate, accumulation 1 and 2), model=2
(fsdp, tensor) and data=2 x model=2 (fsdp, tensor); the tensor-parallel
forward at attention 'auto' and its route; the VF hinge on the whole batch
(a case whose per-rank hinges differ, which a naive per-rank loss fails);
the NaN skip over a sharded gradient.

Tolerances: every step's loss within 1e-6 relative; the first step's
gradients and the parameters after two steps within 1e-5 of the largest
|gradient| / |parameter|. Sums in other orders differ by fp32 rounding
(measured: loss <= 1.8e-7, gradients <= 2.2e-6, parameters <= 7.7e-6 of
the largest). A parameter whose whole gradient lies within that
gradient tolerance of zero is not fixed by it: AdamW and Adafactor
normalise each entry, so such a gradient's sign alone makes a step of up to
lr. In the micro model these are the biases ahead of its 16-channel
GroupNorms (one channel a group: a gradient of rounding noise, <= 5e-8 of
the largest) and the encoder's q/k LayerNorms and projections (near-uniform
attention at init: <= 4.4e-7); they are held to two steps' largest move,
2 x 2 x lr, instead.
"""

import numpy as np
import pytest
import torch

import torch_parallel_jobs as J

torch.set_num_threads(1)
DATA = J.batches(2, 4)
ADAFACTOR = {"optimizer": "adafactor", "max_grad_norm": 0.05}


@pytest.fixture(scope="module")
def pool():
    p = J.RankPool(4)
    yield p
    p.close()


def check(ref, got, steps=2):
    """Each rank's result against the single-process twin (module docstring)."""
    for r in got:
        for a, b in zip(ref["metrics"], r["metrics"], strict=True):
            assert abs(a["total"] - b["total"]) <= 1e-6 * abs(a["total"]), (a, b)
        J.check_grads(ref["grads"], r["grads"])
        J.check_params(ref["grads"], ref["params"], r["params"], steps)


@pytest.mark.parametrize("accum", [1, 2])
def test_replicate_matches_single_process(pool, tmp_path, accum):
    ref = J.train_reference(accum, DATA)
    check(ref, pool.run(J.train, 2, tmp_path, "replicate", 1, accum, DATA))


@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_model_axis_of_two_matches_single_process(pool, tmp_path, mode):
    check(J.train_reference(1, DATA), pool.run(J.train, 2, tmp_path, mode, 2, 1, DATA))


@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_data_two_by_model_two_matches_single_process(pool, tmp_path, mode):
    check(J.train_reference(2, DATA), pool.run(J.train, 4, tmp_path, mode, 2, 2, DATA))


def test_tensor_parallel_depthwise_ffn_matches_single_process(pool, tmp_path):
    """conv_ffn_type='depthwise' under tensor parallelism: the replicated
    depthwise conv on the gathered y, this rank's slice into proj_out."""
    kw = {"conv_ffn_type": "depthwise"}
    check(J.train_reference(1, DATA, model_kw=kw),
          pool.run(J.train, 2, tmp_path, "tensor", 2, 1, DATA, 2, None, None, False, kw))


def test_tensor_forward_takes_the_local_heads_route(pool, tmp_path):
    """No-grad forwards at attention 'auto' (the inference dispatch): the
    four attention sublayers, split (1 and 2 heads a rank), take the
    composable route on their heads; the output equals the single-process
    forward."""
    ref = J.forward_tensor(0, DATA)
    assert ref["routes"] == {"composable": 4}  # fp32 on the CPU: no kernel route
    for r in pool.run(J.forward_tensor, 2, tmp_path, 2, DATA):
        assert r["routes"] == {"local_heads": 4}
        for key in ("recon", "mu"):
            err = float((r[key] - ref[key]).abs().max())
            assert err <= 1e-5 * float(ref[key].abs().max()), (key, err)


def test_vf_hinge_is_taken_on_the_whole_batch(pool, tmp_path):
    """Rank 0's rows align with their features (similarity 0.9), rank 1's
    oppose them (-0.5): the single-process hinge max(0.4 - 0.2, 0) = 0.2,
    the per-rank hinges 0 and 0.9. The port's term and its gradient equal
    the single process's; the naive per-rank term does not."""
    from deepl_project_tpu_torch.losses.vae_loss import vf_loss

    g = torch.Generator().manual_seed(0)
    feats = torch.randn(4, 8, 4, 4, generator=g)
    unit = feats / feats.norm(dim=1, keepdim=True)
    other = torch.randn(4, 8, 4, 4, generator=g)
    other = other - (other * unit).sum(1, keepdim=True) * unit
    other = other / other.norm(dim=1, keepdim=True)
    cos = torch.tensor([0.9, 0.9, -0.5, -0.5])[:, None, None, None]
    x = cos * unit + (1 - cos ** 2).sqrt() * other
    kernel, bias = torch.eye(8), torch.zeros(8)
    xr = x.clone().requires_grad_(True)
    want = vf_loss(xr, feats, kernel, bias)
    (want_grad,) = torch.autograd.grad(want, xr)
    want = float(want.detach())
    assert abs(want - 0.2) < 1e-5
    ours = pool.run(J.vf_term, 2, tmp_path, x, feats, kernel, bias, False)
    naive = pool.run(J.vf_term, 2, tmp_path, x, feats, kernel, bias, True)
    for r in ours:
        assert abs(r["loss"] - want) <= 1e-6 * want
        assert float((r["grad"] - want_grad).abs().max()) <= 1e-6 * float(want_grad.abs().max())
    assert abs(naive[0]["loss"] - want) > 0.1  # (0 + 0.9) / 2 = 0.45


def test_vf_step_matches_single_process(pool, tmp_path):
    """The whole step with the VF term on (a stub teacher, the eager
    projection trained), accumulation 2 over data=2."""
    kw = dict(teacher=True, weights={"vf": 0.1})
    ref = J.train_reference(2, DATA, **kw)
    assert ref["metrics"][0]["vf"] > 0
    check(ref, pool.run(J.train, 2, tmp_path, "replicate", 1, 2, DATA, 2, {"vf": 0.1}, None,
                        True))


@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_adafactor_and_the_clip_under_sharding(pool, tmp_path, mode):
    """Adafactor's factored moments over split dimensions and the global
    norm's clip (max_grad_norm 0.05, below every step's norm)."""
    ref = J.train_reference(1, DATA, opt=ADAFACTOR)
    assert all(m["grad_norm"] > 0.05 for m in ref["metrics"])
    check(ref, pool.run(J.train, 2, tmp_path, mode, 2, 1, DATA, 2, None, ADAFACTOR))


@pytest.mark.parametrize("mode", ["fsdp", "tensor"])
def test_nan_skip_over_a_sharded_gradient(pool, tmp_path, mode):
    """A NaN in the last model rank's slice of proj_out's gradient: every
    rank skips the step and keeps its parameters, as one process does."""
    ref = J.nan_step(None, 1, DATA)
    assert not ref["applied"] and ref["skipped"] == 1
    for r in pool.run(J.nan_step, 2, tmp_path, mode, 2, DATA):
        assert not r["applied"] and r["skipped"] == 1
        for k, v in r["before"].items():
            assert torch.equal(v, r["params"][k]), k
    assert np.isfinite([float(v.sum()) for v in ref["params"].values()]).all()


def test_collectives_forward_and_backward(pool, tmp_path):
    """Each collective on 2 ranks (rank r holds x * (r + 1)): its output,
    and its backward as the module docstring of parallel/collectives.py
    states it, against the sums written out by hand."""
    x = torch.arange(1.0, 9.0).reshape(4, 2)
    xs = [x, 2 * x]
    w = 1.0 + torch.arange(8.0).reshape(4, 2)  # the weights of a (4, 2) output
    w8 = 1.0 + torch.arange(16.0).reshape(8, 2)
    w2 = 1.0 + torch.arange(4.0).reshape(2, 2)
    for r, got in enumerate(pool.run(J.collectives, 2, tmp_path, x)):
        def eq(name, y, g):
            assert torch.allclose(got[name][0], y), (name, got[name][0], y)
            assert torch.allclose(got[name][1], g), (name, got[name][1], g)
        eq("copy", xs[r], 2 * w)                              # backward: sum of peers' w
        eq("reduce", xs[0] + xs[1], w)                        # backward: identity
        eq("gather", torch.cat(xs), w8[4 * r:4 * r + 4])      # backward: this rank's slice
        eq("gather_reduce_grad", torch.cat(xs), 2 * w8[4 * r:4 * r + 4])
        eq("scatter", xs[r][2 * r:2 * r + 2],                 # backward: gathered
           torch.cat([w2, w2]))
        eq("reduce_scatter", (xs[0] + xs[1])[2 * r:2 * r + 2], torch.cat([w2, w2]))
        eq("global_mean", (xs[0] + xs[1]) / 2, w)             # backward: unscaled
        mean = [(x + 2 * x) / 2, (x[:1] + 2 * x[:1]) / 2]
        for a, b in zip(got["all_reduce_mean_"], mean):
            assert torch.equal(a, b)
