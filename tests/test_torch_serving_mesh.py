"""The port's serving on a (data, 1, model) mesh of gloo ranks on the CPU
(harness: tests/torch_parallel_jobs.py's RankPool; rank jobs in the
JAX-free tests/torch_serving_jobs.py), held against the JAX package's mesh
engine on the 8 virtual CPU devices and against the port's single-process
engine on the same weights.

tests/test_torch_serving.py's micro model (fp32, 16px, 2 heads of 16 in
its attention stage). Against JAX's engine: that file's atol 2e-4 / rtol
1e-4; against the port's one process: rtol 1e-5 / atol 1e-6, the JAX
package's own bar for its mesh engine (tests/test_serving.py).
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_jobs as PJ
import torch_serving_jobs as J
from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.cli import serve as jax_serve_cli
from deepl_project_tpu.parallel.mesh import create_mesh as jax_create_mesh
from deepl_project_tpu.serving import InferenceEngine as JaxEngine
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch.cli import serve as serve_cli
from deepl_project_tpu_torch.serving import InferenceEngine

torch.set_num_threads(2)
MODES = ("tensor", "fsdp", "replicate")
MESHES = ((1, 2), (2, 1), (2, 2))  # (data, model)
X = np.random.default_rng(0).random((4, 16, 16, 3), dtype=np.float32)
# A bucketed batch, an odd batch of 3 (bucket 4), one row (bucket 1), an encode.
REQUESTS = [("reconstruct", X, None), ("reconstruct", X[:3], None),
            ("reconstruct", X[:1], None), ("encode", X, None)]


@pytest.fixture(scope="module")
def pool():
    p = PJ.RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def one_process():
    engine = InferenceEngine(J.build_model(), max_batch=8)
    return [engine.run(op, arr, dt) for op, arr, dt in REQUESTS]


@pytest.fixture(scope="module")
def jax_mesh():
    """JAX's mesh engine (model 2 on the 8 devices: data 4) per placement:
    its results for REQUESTS."""
    sd = {k: v.numpy() for k, v in J.build_model().state_dict().items()}
    cfg = jax_get_config(J.VARIANT, **J.MICRO, attention_impl="xla")
    params = jax.tree_util.tree_map(jax.numpy.asarray, torch_state_dict_to_params(sd, cfg))
    out = {}
    for mode in MODES:
        engine = JaxEngine(JaxTransVAE(cfg), params, max_batch=8,
                           mesh=jax_create_mesh(model=2), param_sharding=mode)
        out[mode] = [engine.run(op, arr, dt) for op, arr, dt in REQUESTS]
    return out


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_mesh_engine_matches_jax_and_one_process(pool, tmp_path, jax_mesh, one_process,
                                                 mode, data, model):
    want_jax = jax_mesh[mode]
    ranks = pool.run(J.mesh_runs, data * model, tmp_path, mode, model, REQUESTS)
    got = ranks[0]["results"]
    for (op, arr, _), g, j, o in zip(REQUESTS, got, want_jax, one_process, strict=True):
        assert g.shape == j.shape == o.shape and g.dtype == j.dtype, (op, arr.shape)
        np.testing.assert_allclose(g, j, atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(g, o, atol=1e-6, rtol=1e-5)
    assert ranks[0]["stats"]["mesh"] == {"data": data, "context": 1, "model": model}
    # Parameters split only where the model axis has two ranks and the
    # placement splits.
    for r in ranks:
        assert (r["split"] > 0) == (model == 2 and mode != "replicate"), r["split"]


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_odd_batch_is_placed_by_its_bucket(pool, tmp_path, data, model):
    # Decided on the bucketed size: 4 rows (3 padded) split over data 2, 2
    # a rank; 1 row does not divide it, so every rank computes it whole.
    # Without a data axis every rank computes every bucket whole.
    ranks = pool.run(J.mesh_runs, data * model, tmp_path, "tensor", model, REQUESTS)
    for r in ranks:
        assert r["rows"] == ([2, 2, 1, 2] if data == 2 else [4, 4, 1, 4]), r["rows"]


def test_http_round_trip_while_a_rank_follows(pool, tmp_path, one_process):
    ranks = pool.run(J.http_round_trip, 2, tmp_path, "tensor", 2, X)
    got = ranks[0]
    for out in (got["reconstruct"], got["again"]):
        np.testing.assert_allclose(out, one_process[0], atol=1e-6, rtol=1e-5)
    assert got["heartbeats"] >= 2  # the follower stayed in step through them
    assert got["refused"] == 400  # validated on rank 0: nothing went out
    assert "dispatcher" in got["run_while_dispatching"]
    assert ranks[1] == {"left_follow": True}  # stop() released the follower


@pytest.mark.parametrize("when", ["idle", "group"])
def test_a_failed_follower_stops_the_server(pool, tmp_path, when):
    # A follower that leaves while rank 0 idles breaks its next heartbeat;
    # one whose forward raises breaks rank 0's forward. Either way rank 0's
    # engine is failed, the waiting request gets its error and run_server
    # exits non-zero within a bounded time instead of serving on.
    lead, follower = pool.run(J.follower_fails, 2, tmp_path, when, X)
    assert follower == ({"left": True} if when == "idle"
                        else {"follow_raised": "injected follower failure"})
    assert lead["failed"] and "failed" in lead["exit"], lead
    # The request that met the failure carries the collective's error; one
    # sent after it, the engine's.
    assert lead["status"] == 400, lead
    assert ("the mesh engine failed" if when == "idle" else "RuntimeError") in lead["body"]
    assert lead["client_done"] and lead["seconds"] < 20, lead


def _checkpoint(tmp_path):
    path = tmp_path / "micro.pt"
    torch.save({"model_state_dict": J.build_model().state_dict(),
                "config": {"variant": J.VARIANT, **{k: list(v) if isinstance(v, tuple) else v
                                                    for k, v in J.MICRO.items()}}}, path)
    return str(path)


def test_int8_on_a_mesh_is_replicated(pool, tmp_path):
    argv = ["--checkpoint", _checkpoint(tmp_path), "--device", "cpu", "--max_batch", "8",
            "--quantize", "int8", "--warmup_resolution", "16", "--mesh_model", "2"]
    ranks = pool.run(J.cli_engine, 2, tmp_path, argv, X)
    assert [r["mode"] for r in ranks] == ["replicate"] * 2
    assert [r["split"] for r in ranks] == [0, 0]
    want = serve_cli.build_engine(serve_cli.build_parser().parse_args(argv)).run(
        "reconstruct", X)
    np.testing.assert_array_equal(ranks[0]["reconstruct"], want)


def test_serve_cli_on_a_mesh_answers_a_request(pool, tmp_path, one_process):
    argv = ["--checkpoint", _checkpoint(tmp_path), "--device", "cpu", "--max_batch", "8",
            "--port", "0", "--mesh_model", "2", "--mesh_sharding", "tensor"]
    ranks = pool.run(J.cli_main, 2, tmp_path, argv, 2, X)
    np.testing.assert_allclose(ranks[0]["reconstruct"], one_process[0], atol=1e-6, rtol=1e-5)
    assert ranks[0]["stats"]["mesh"] == {"data": 1, "context": 1, "model": 2}
    assert all(r["group_left"] for r in ranks)


def test_fsdp_keeps_the_packed_operands(pool, tmp_path):
    (got, _) = pool.run(J.fsdp_operand_cache, 2, tmp_path)
    assert got["split"] > 0 and got["same"] and got["built_once"] == 1
    assert got["rebuilt"] and got["builds"] == 2 and got["fresh_right"]


def test_serve_cli_flags_match_jax():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings} - {"-h", "--help"}

    jax_flags = flags(jax_serve_cli.build_parser()) - {"--compile_cache_dir", "--platform"}
    assert flags(serve_cli.build_parser()) == jax_flags | {"--device"}
