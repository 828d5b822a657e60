"""Rank jobs of tests/test_torch_serving_mesh.py (JAX-free: the ranks of
tests/torch_parallel_jobs.py's RankPool import this module by name): the
port's InferenceEngine and serve CLI on a (data, 1, model) mesh of gloo
ranks on the CPU. Global rank 0 runs the requests; the other ranks follow.
"""

from __future__ import annotations

import io
import os
import threading
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

# tests/test_torch_serving.py's micro model: 3 stages at 16px, fp32, the
# last stage's attention 2 heads of 16 at C=32.
VARIANT = "tiny_f16d32"
MICRO = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), latent_dim=4, head_dim=16,
             dtype="float32")
# FSDP's size threshold for the micro model (the default 2**16 splits
# nothing there).
FSDP_MIN = 1024


def build_model():
    from deepl_project_tpu_torch import create_transvae

    return create_transvae(VARIANT, device="cpu", seed=0, **MICRO)


def _engine(mode: str, model_size: int, **kw):
    from deepl_project_tpu_torch.parallel import create_mesh, sharding
    from deepl_project_tpu_torch.serving import InferenceEngine

    sharding.FSDP_MIN_SIZE = FSDP_MIN
    return InferenceEngine(build_model(), max_batch=8, mesh=create_mesh(model=model_size),
                           param_sharding=mode, **kw)


def _record_rows(engine) -> list:
    """The batch sizes this rank's forwards take, in order."""
    rows, compute = [], engine._compute

    def counted(op, x, out_dtype):
        rows.append(int(x.shape[0]))
        return compute(op, x, out_dtype)

    engine._compute = counted
    return rows


def mesh_runs(mode: str, model_size: int, requests: list) -> dict:
    """``engine.run(op, arr, dtype)`` of each request on rank 0 while the
    others follow; every rank's forward sizes, the parameters it splits and
    (rank 0) the results and ``stats()``."""
    engine = _engine(mode, model_size)
    rows = _record_rows(engine)
    out = {"split": sum(d is not None for d in map(engine.placement.dim,
                                                    engine.placement.specs)),
           "rows": rows}
    if dist.get_rank() == 0:
        out["results"] = [engine.run(op, arr, dt) for op, arr, dt in requests]
        out["stats"] = engine.stats()
        engine.stop()
    else:
        engine.follow()
    return out


def _post(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    with urllib.request.urlopen(url, data=buf.getvalue(), timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


def http_round_trip(mode: str, model_size: int, x: np.ndarray) -> dict:
    """One reconstruct over HTTP through rank 0's dispatcher, after it
    idled through heartbeats (every 50 ms here), and a request the engine
    refuses before anything goes out (400); the followers leave follow() at
    stop()."""
    import time
    import urllib.error

    from deepl_project_tpu_torch import serving
    from deepl_project_tpu_torch.serving import make_http_server

    serving.HEARTBEAT_S = 0.05
    engine = _engine(mode, model_size, batch_window_ms=5.0)
    if dist.get_rank() != 0:
        engine.follow()
        return {"left_follow": True}
    beats, heartbeat = [], engine._heartbeat
    engine._heartbeat = lambda: beats.append(1) or heartbeat()
    engine.start()
    time.sleep(0.5)
    server = make_http_server(engine, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        out = {"reconstruct": _post(f"{base}/reconstruct", x), "heartbeats": len(beats)}
        try:
            _post(f"{base}/reconstruct", np.zeros((1, 4, 4, 4), np.float32))
        except urllib.error.HTTPError as e:
            out["refused"] = e.code
        out["again"] = _post(f"{base}/reconstruct", x)
        try:
            engine.run("reconstruct", x)  # not the dispatcher's thread
        except RuntimeError as e:
            out["run_while_dispatching"] = str(e)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    return out


def follower_fails(when: str, x: np.ndarray) -> dict:
    """Rank 1 fails: ``idle`` it leaves the group while rank 0's dispatcher
    idles through heartbeats, ``group`` its forward raises in a request's
    group and it leaves. Rank 0 runs cli.serve's run_server: its engine is
    marked failed, a request is answered with an error (never left
    waiting), and run_server exits non-zero; the seconds that took."""
    import time
    import urllib.error

    from deepl_project_tpu_torch import serving
    from deepl_project_tpu_torch.cli import serve as cli
    from deepl_project_tpu_torch.serving import make_http_server

    serving.HEARTBEAT_S = 0.05
    engine = _engine("tensor", 2, batch_window_ms=5.0)
    if dist.get_rank() != 0:
        if when == "group":
            def broken(op, x, out_dtype):
                raise RuntimeError("injected follower failure")

            engine._compute = broken
            try:
                engine.follow()
            except RuntimeError as e:
                return {"follow_raised": str(e)}
            finally:
                dist.destroy_process_group()  # as the process would on exiting
        dist.destroy_process_group()
        return {"left": True}
    engine.start()
    server = make_http_server(engine, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}/reconstruct"
    out: dict = {}

    def client():
        if when == "idle":
            while engine.failed is None:
                time.sleep(0.01)
        try:
            _post(url, x)
        except urllib.error.HTTPError as e:
            out["status"], out["body"] = e.code, e.read().decode()

    th = threading.Thread(target=client, daemon=True)
    th.start()
    t0 = time.monotonic()
    try:
        cli.run_server(engine, server)
    except SystemExit as e:
        out["exit"] = str(e.code)
    out["seconds"] = time.monotonic() - t0
    th.join(timeout=30)
    out["client_done"] = not th.is_alive()
    out["failed"] = engine.failed
    return out


def cli_engine(argv: list, x: np.ndarray) -> dict:
    """cli.serve's build_engine on a model-2 mesh: the placement it picks,
    and (rank 0) one reconstruct."""
    from deepl_project_tpu_torch.cli import serve as cli
    from deepl_project_tpu_torch.parallel import create_mesh

    engine = cli.build_engine(cli.build_parser().parse_args(argv), create_mesh(model=2))
    out = {"mode": engine.placement.mode,
           "split": sum(d is not None for d in map(engine.placement.dim,
                                                   engine.placement.specs))}
    if dist.get_rank() == 0:
        out["reconstruct"] = engine.run("reconstruct", x)
        engine.stop()
    else:
        engine.follow()
    return out


def cli_main(argv: list, world: int, x: np.ndarray) -> dict:
    """python -m deepl_project_tpu_torch.cli.serve as torchrun starts it
    (RANK / WORLD_SIZE / LOCAL_RANK set, the group already joined): rank 0
    answers one request, then its server shuts down and main() returns on
    every rank."""
    from deepl_project_tpu_torch.cli import serve as cli

    rank = dist.get_rank()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    out: dict = {}
    run_server = cli.run_server

    def answering(engine, server):
        def client():
            try:
                out["reconstruct"] = _post(
                    f"http://127.0.0.1:{server.server_address[1]}/reconstruct", x)
                out["stats"] = engine.stats()
            finally:
                server.shutdown()

        threading.Thread(target=client, daemon=True).start()
        run_server(engine, server)

    cli.run_server = answering
    try:
        cli.main(argv)
    finally:
        cli.run_server = run_server
    out["group_left"] = not dist.is_initialized()
    return out


def fsdp_operand_cache() -> dict:
    """An attention module under FSDP (model 2) in inference mode: its packed
    sublayer operands built once across forwards' calls, rebuilt when a
    shard changes in place, and equal to pack_qkv of the whole weights."""
    from deepl_project_tpu_torch.ops import attention as attn_mod
    from deepl_project_tpu_torch.ops.attention import AttentionRoPE
    from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
    from deepl_project_tpu_torch.parallel import create_mesh, shard_params

    torch.manual_seed(0)
    m = AttentionRoPE(128, 64)
    whole = {k: v.clone() for k, v in m.state_dict().items()}
    placement = shard_params(create_mesh(model=2), m, "fsdp", fsdp_min_size=1024)
    made = []
    pack = attn_mod.pack_qkv
    attn_mod.pack_qkv = lambda *a, **kw: made.append(1) or pack(*a, **kw)
    try:
        with torch.inference_mode():
            first = m._packed_qkv()
            again = m._packed_qkv()
            built_once = len(made)
        with torch.no_grad():
            m.to_q.parametrizations.weight.original.add_(1.0)
        with torch.inference_mode():
            fresh = m._packed_qkv()
    finally:
        attn_mod.pack_qkv = pack
    ln = tuple((whole[f"norm_{b}.weight"], whole[f"norm_{b}.bias"]) for b in "qkv")
    want = fab.pack_qkv(ln, whole["to_q.weight"] + 1.0, whole["to_k.weight"],
                        whole["to_v.weight"], 64)
    return {"split": sum(d is not None for d in map(placement.dim, placement.specs)),
            "same": again is first, "built_once": built_once, "rebuilt": fresh is not first,
            "builds": len(made), "fresh_right": all(torch.equal(a, b)
                                                    for a, b in zip(fresh, want))}
