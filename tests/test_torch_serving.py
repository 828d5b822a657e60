"""The port's InferenceEngine / HTTP server / serve CLI on the CPU, held
against the JAX package's engine on the same weights.

A micro 3-stage model at 16px (the JAX serving tests' config), fp32; the
engines' outputs are sigmoid images in [0, 1] and latents: atol 2e-4, rtol
1e-4 (the models agree to ~1e-5 on these; uint8 encodings may differ by one
step where a value sits on a rounding boundary).
"""

import io
import shutil
import socket
import ssl
import subprocess
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.serving import InferenceEngine as JaxEngine
from deepl_project_tpu.utils.convert import torch_state_dict_to_params
from deepl_project_tpu_torch import create_transvae
from deepl_project_tpu_torch.cli import serve as serve_cli
from deepl_project_tpu_torch.serving import (EngineOverloaded, InferenceEngine,
                                             make_http_server)

torch.set_num_threads(2)
MICRO = dict(depths=(1, 1, 1), base_dims=(16, 16, 32), latent_dim=4, head_dim=16,
             dtype="float32")


def _model():
    return create_transvae("tiny_f16d32", device="cpu", seed=0, **MICRO)


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(_model(), max_batch=8, batch_window_ms=20.0)


@pytest.fixture(scope="module")
def jax_engine(engine):
    sd = {k: v.numpy() for k, v in engine.model.state_dict().items()}
    cfg = jax_get_config("tiny_f16d32", **MICRO, attention_impl="xla")
    params = jax.tree_util.tree_map(jax.numpy.asarray, torch_state_dict_to_params(sd, cfg))
    return JaxEngine(JaxTransVAE(cfg), params, max_batch=8)


def _imgs(b, seed=0):
    return np.random.default_rng(seed).random((b, 16, 16, 3), dtype=np.float32)


@pytest.mark.parametrize("op,dtype,uint8_in", [("reconstruct", None, False),
                                               ("reconstruct", "uint8", True),
                                               ("encode", "float16", False),
                                               ("decode", None, False)])
def test_engine_matches_jax_engine(engine, jax_engine, op, dtype, uint8_in):
    x = _imgs(3, seed=1)
    if op == "decode":
        x = np.random.default_rng(2).standard_normal((3, 4, 4, 4)).astype(np.float32)
    elif uint8_in:
        x = (x * 255).astype(np.uint8)
    got = engine.run(op, x, dtype)
    want = jax_engine.run(op, x, dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    atol = 1 if dtype == "uint8" else (1e-3 if dtype == "float16" else 2e-4)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=atol, rtol=1e-4)


def test_engine_shapes_padding_and_split(engine):
    x = _imgs(3)
    mu = engine.run("encode", x)
    assert mu.shape == (3, 4, 4, 4) and mu.dtype == np.float32
    img = engine.run("decode", mu)
    assert img.shape == (3, 16, 16, 3) and 0.0 <= img.min() and img.max() <= 1.0
    r3 = engine.run("reconstruct", x)  # padded to the 4-bucket
    np.testing.assert_allclose(r3[:1], engine.run("reconstruct", x[:1]), atol=1e-5)
    assert engine.run("reconstruct", _imgs(9)).shape[0] == 9  # > max_batch
    assert "reconstruct/None/False/4/16/16/3" in engine.stats()["warm_shapes"]


def test_uint8_request_matches_float(engine):
    xi = np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    np.testing.assert_allclose(engine.run("reconstruct", xi),
                               engine.run("reconstruct", xi.astype(np.float32) / 255.0),
                               atol=1e-5)


def test_dynamic_batcher_groups_concurrent_requests(engine):
    engine.start()
    try:
        xs = [_imgs(1, seed=10 + i) for i in range(4)]
        outs = [None] * 4

        def worker(i):
            outs[i] = engine.submit("reconstruct", xs[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for x, o in zip(xs, outs):
            np.testing.assert_allclose(o, engine.run("reconstruct", x), atol=1e-5)
        assert engine.submit("reconstruct", _imgs(9)).shape[0] == 9  # chunked
    finally:
        engine.stop()


def _serve(engine, **kw):
    engine.start()
    server = make_http_server(engine, "127.0.0.1", 0, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, arr, headers=None):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


def test_http_round_trip_and_auth(engine):
    server, base = _serve(engine, auth_token="s3cret", max_request_bytes=8192)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert b"variant" in r.read()  # probes need no token
        auth = {"Authorization": "Bearer s3cret"}
        out = _post(f"{base}/reconstruct?dtype=uint8", _imgs(2), auth)
        assert out.dtype == np.uint8 and out.shape == (2, 16, 16, 3)
        for hdrs, code, arr in (({}, 401, _imgs(1)),
                                ({"Authorization": "Bearer no"}, 401, _imgs(1)),
                                (auth, 413, _imgs(4)),  # 12 KB body > 8 KB cap
                                (auth, 400, np.zeros((1, 4, 4, 4), np.float32))):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{base}/reconstruct", arr, hdrs)
            assert ei.value.code == code
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/encode?dtype=uint8", _imgs(1), auth)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


def test_https_round_trip(engine, tmp_path):
    # TLS with a self-signed cert; the handshake runs in the handler thread,
    # so an idle plain-TCP client does not block other connections.
    if shutil.which("openssl") is None:
        pytest.skip("openssl CLI needed to mint a test cert")
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                    "-keyout", str(key), "-out", str(cert), "-days", "1",
                    "-subj", "/CN=localhost"], check=True, capture_output=True)
    server, base = _serve(engine, auth_token="tok", tls_cert=str(cert), tls_key=str(key))
    base = base.replace("http://", "https://")
    try:
        ctx = ssl.create_default_context(cafile=str(cert))
        ctx.check_hostname = False
        buf = io.BytesIO()
        np.save(buf, _imgs(1))
        req = urllib.request.Request(f"{base}/reconstruct", data=buf.getvalue(),
                                     headers={"Authorization": "Bearer tok"})
        with urllib.request.urlopen(req, context=ctx, timeout=60) as r:
            assert np.load(io.BytesIO(r.read())).shape == (1, 16, 16, 3)
        idle = socket.create_connection(("127.0.0.1", server.server_address[1]), timeout=10)
        try:
            with urllib.request.urlopen(f"{base}/healthz", context=ctx, timeout=10) as r:
                assert b"variant" in r.read()
        finally:
            idle.close()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


def test_bounded_queue_overload():
    eng = InferenceEngine(_model(), max_batch=8, max_queue=1)
    eng._thread = object()  # a dispatcher that never drains
    x = _imgs(1)
    eng._queue.put_nowait((("reconstruct", None), x, threading.Event(), {}))
    with pytest.raises(EngineOverloaded):
        eng.submit("reconstruct", x)


def test_stop_fails_queued_and_carried_requests(engine):
    engine.start()
    errs, threads = [], []
    try:
        def worker(op):
            try:
                engine.submit(op, _imgs(1))
            except RuntimeError as e:
                errs.append(str(e))

        for op in ("reconstruct", "encode"):  # the second is carried
            threads.append(threading.Thread(target=worker, args=(op,)))
            threads[-1].start()
    finally:
        engine.stop()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def test_warmup_ladder_includes_non_pow2_cap_and_default_encoding():
    eng = InferenceEngine(_model(), max_batch=6)
    eng.warmup(16, ops=("decode", "reconstruct"), dtypes=("uint8",))
    warm = eng.stats()["warm_shapes"]
    assert "decode/None/False/6/4/4/4" in warm
    assert "reconstruct/None/False/1/16/16/3" in warm
    assert "reconstruct/uint8/False/4/16/16/3" in warm


def test_serve_cli_refuses_what_is_not_ported():
    for argv in (["--quantize", "int8"], ["--mesh_model", "2"],
                 ["--tls_cert", "only.pem"]):
        with pytest.raises(SystemExit):
            serve_cli.main(argv)


def test_serve_cli_loads_reference_checkpoint(tmp_path):
    # The .pt layout scripts/export_to_torch.py writes from a JAX checkpoint;
    # its "config" may carry field overrides (here the micro widths).
    src = _model()
    path = tmp_path / "model.pt"
    torch.save({"model_state_dict": {k: v.clone() for k, v in src.state_dict().items()},
                "config": {"variant": "tiny_f16d32", "compression_ratio": 16,
                           "latent_dim": 4, "depths": [1, 1, 1],
                           "base_dims": [16, 16, 32], "head_dim": 16,
                           "dtype": "float32"}}, path)
    args = serve_cli.build_parser().parse_args(
        ["--checkpoint", str(path), "--device", "cpu", "--max_batch", "4"])
    eng = serve_cli.build_engine(args)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(eng.model.state_dict()[k], v)
    x = _imgs(2)
    np.testing.assert_allclose(eng.run("reconstruct", x),
                               InferenceEngine(src).run("reconstruct", x), atol=1e-6)
