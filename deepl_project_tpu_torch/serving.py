"""Batched inference serving for TransVAE (PyTorch port of ``serving.py``).

A threaded HTTP server with dynamic batching in front of encode / decode /
reconstruct:

- Requests are bucketed to power-of-two batch sizes (zero-padded, unpadded
  on reply), so the device sees a handful of shapes; ``warmup`` runs the
  whole ladder once before traffic.
- One dispatcher thread owns the device. It drains the queue, groups
  compatible requests within a small window and enqueues ONE forward pass per
  group on the engine's CUDA stream, together with the device->host copy into
  pinned memory and an event. A fetch thread waits on the events and hands
  results to the waiting requests, so the device computes the next group
  while the previous one is copied out (the role JAX's async dispatch plays
  in the JAX engine).
- Outputs are encoded on the device (uint8 or float16) before the copy.
- Payloads are raw ``.npy`` in and out, NHWC like the JAX engine's.

Endpoints:
  GET  /healthz      -> JSON status
  POST /encode       -> npy [B,H,W,3] in [0,1] (or uint8) -> npy mu [B,h,w,D]
  POST /decode       -> npy [B,h,w,D] latents -> npy images [B,H,W,3] in [0,1]
  POST /reconstruct  -> npy [B,H,W,3] -> npy images [B,H,W,3] (encode->mu->decode)
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time

import numpy as np
import torch


def _next_pow2(n: int, cap: int) -> int:
    p = 1
    while p < n and p < cap:
        p *= 2
    return min(p, cap)


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the bounded request queue is full."""


class _Pending:
    """A result on its way to the host: ``numpy()`` waits for it."""

    def __init__(self, host: torch.Tensor, event=None):
        self.host, self.event = host, event

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class InferenceEngine:
    """Dynamic batcher around one TransVAE model (eval mode, inference only)."""

    def __init__(self, model, max_batch: int = 32, batch_window_ms: float = 3.0,
                 max_queue: int = 256):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1e3
        self._warm: set = set()
        # Bounded: under overload, fail fast (HTTP 503) instead of growing an
        # unbounded backlog.
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._fetch_thread: threading.Thread | None = None

    # -- device functions -------------------------------------------------
    def _compute(self, op: str, x: torch.Tensor, out_dtype: str | None) -> torch.Tensor:
        cd = self.model.config.compute_dtype
        if x.dtype == torch.uint8:
            # uint8 payloads upload a quarter of fp32's bytes; scale on device.
            x = x.to(cd) * torch.tensor(1.0 / 255.0, dtype=cd, device=x.device)
        else:
            x = x.to(cd)
        x = x.permute(0, 3, 1, 2)  # NHWC request -> NCHW model input

        def finish(logits):
            y = torch.sigmoid(logits.float())
            if out_dtype == "uint8":
                return torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.uint8)
            if out_dtype == "float16":
                return y.half()
            return y

        if op == "encode":
            mu, _ = self.model.encode(x)
            y = mu.half() if out_dtype == "float16" else mu.float()
        elif op == "decode":
            y = finish(self.model.decode(x))
        elif op == "reconstruct":
            y = finish(self.model(x, sample=False)[0])
        else:
            raise ValueError(op)
        return y.permute(0, 2, 3, 1).contiguous()

    def run_async(self, op: str, arr: np.ndarray, out_dtype: str | None = None) -> _Pending:
        """Enqueue one bucketed batch; returns a handle whose ``numpy()``
        waits for the result (padded rows included)."""
        b = arr.shape[0]
        bb = _next_pow2(b, self.max_batch)
        assert bb >= b, (b, self.max_batch)
        if bb != b:
            arr = np.concatenate([arr, np.zeros((bb - b,) + arr.shape[1:], arr.dtype)])
        if arr.dtype != np.uint8:
            arr = np.asarray(arr, np.float32)
        self._warm.add((op, out_dtype, arr.dtype == np.uint8) + arr.shape)
        with torch.inference_mode():
            if self.stream is None:
                return _Pending(self._compute(op, torch.from_numpy(arr), out_dtype))
            with torch.cuda.stream(self.stream):
                x = torch.from_numpy(arr).to(self.device, non_blocking=True)
                y = self._compute(op, x, out_dtype)
                host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                host.copy_(y, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
            return _Pending(host, event)

    def run(self, op: str, arr: np.ndarray, out_dtype: str | None = None) -> np.ndarray:
        """Run one already-batched array (pads to the bucket; splits batches
        larger than max_batch)."""
        b = arr.shape[0]
        if b > self.max_batch:
            return np.concatenate([self.run(op, arr[i:i + self.max_batch], out_dtype)
                                   for i in range(0, b, self.max_batch)], axis=0)
        return self.run_async(op, arr, out_dtype).numpy()[:b]

    # -- dynamic batching -------------------------------------------------
    def submit(self, op: str, arr: np.ndarray, out_dtype: str | None = None) -> np.ndarray:
        """Thread-safe: enqueue a request and wait for its result. Requests
        with the same (op, out_dtype, item shape, dtype) arriving within the
        batch window run as one forward pass."""
        if self._thread is None:
            return self.run(op, arr, out_dtype)  # dispatcher not started
        if arr.shape[0] > self.max_batch:
            return np.concatenate(
                [self.submit(op, arr[i:i + self.max_batch], out_dtype)
                 for i in range(0, arr.shape[0], self.max_batch)], axis=0)
        ev = threading.Event()
        slot: dict = {}
        try:
            self._queue.put_nowait(((op, out_dtype), arr, ev, slot))
        except queue.Full:
            raise EngineOverloaded(f"request queue full ({self._queue.maxsize})") from None
        ev.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def start(self):
        self._stop.clear()
        self._fetch_q = queue.Queue(maxsize=2)  # bounded in-flight pipeline
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._fetch_thread = threading.Thread(target=self._fetch_loop, daemon=True)
        self._thread.start()
        self._fetch_thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._fetch_thread is not None:
            self._fetch_q.put(None)
            self._fetch_thread.join(timeout=5)
            self._fetch_thread = None
        # Fail requests still queued, or their submit() callers block forever.
        while True:
            try:
                _, _, ev, slot = self._queue.get_nowait()
            except queue.Empty:
                break
            slot["error"] = "engine stopped"
            ev.set()

    def _dispatch_loop(self):
        carried = None  # an incompatible request heads the NEXT group
        while not self._stop.is_set():
            if carried is not None:
                first, carried = carried, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            group = [first]
            (op, out_dtype), arr0 = first[0], first[1]
            deadline = time.monotonic() + self.batch_window_s
            total = arr0.shape[0]
            while total < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if (nxt[0] == (op, out_dtype)
                        and nxt[1].shape[1:] == arr0.shape[1:]
                        and nxt[1].dtype == arr0.dtype
                        and total + nxt[1].shape[0] <= self.max_batch):
                    group.append(nxt)
                    total += nxt[1].shape[0]
                else:
                    carried = nxt
                    break
            try:
                batch = np.concatenate([g[1] for g in group], axis=0)
                pending = self.run_async(op, batch, out_dtype)
                self._fetch_q.put((pending, batch.shape[0], group))
            except Exception as e:  # noqa: BLE001 -- report to all waiters
                for _, _, ev, slot in group:
                    slot["error"] = f"{type(e).__name__}: {e}"
                    ev.set()
        if carried is not None:  # stop() raced a carried request: fail it
            carried[3]["error"] = "engine stopped"
            carried[2].set()

    def _fetch_loop(self):
        while True:
            item = self._fetch_q.get()
            if item is None:
                return
            pending, nreal, group = item
            try:
                out = pending.numpy()[:nreal]
                ofs = 0
                for _, a, ev, slot in group:
                    slot["result"] = out[ofs:ofs + a.shape[0]]
                    ofs += a.shape[0]
                    ev.set()
            except Exception as e:  # noqa: BLE001
                for _, _, ev, slot in group:
                    slot["error"] = f"{type(e).__name__}: {e}"
                    ev.set()

    def warmup(self, resolution: int, ops: tuple = ("encode", "decode", "reconstruct"),
               dtypes: tuple = (None,), uint8_inputs: bool = False):
        """Run the full power-of-two batch-bucket ladder of each op once, so
        steady-state traffic meets warm allocator pools and kernels."""
        cfg = self.model.config
        f = cfg.compression_ratio
        if None not in dtypes:  # default-encoding traffic must be warm too
            dtypes = (None,) + tuple(dtypes)
        buckets, b = [], 1
        while b <= self.max_batch:
            buckets.append(b)
            b *= 2
        if buckets[-1] != self.max_batch:
            buckets.append(self.max_batch)  # a non-pow2 cap is a live bucket
        for op in ops:
            for bb in buckets:
                if op == "decode":
                    arr = np.zeros((bb, resolution // f, resolution // f,
                                    cfg.latent_dim), np.float32)
                else:
                    arr = np.zeros((bb, resolution, resolution, 3),
                                   np.uint8 if uint8_inputs else np.float32)
                for dt in dtypes:
                    if op == "encode" and dt == "uint8":
                        continue  # the handler rejects this combination
                    self.run(op, arr, dt)

    def stats(self) -> dict:
        dev = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
               else str(self.device))
        return {"device": dev, "variant": self.model.config.variant,
                "warm_shapes": sorted("/".join(map(str, k)) for k in list(self._warm)),
                "max_batch": self.max_batch}


def make_http_server(engine: InferenceEngine, host: str = "127.0.0.1",
                     port: int = 8471, auth_token: str | None = None,
                     max_request_bytes: int = 64 << 20,
                     tls_cert: str | None = None, tls_key: str | None = None):
    """Build (not start) a ThreadingHTTPServer bound to the engine.

    ``auth_token``: POSTs must carry ``Authorization: Bearer <token>``
    (``/healthz`` stays open). ``max_request_bytes``: larger bodies get 413
    before being read. ``tls_cert``/``tls_key``: PEM paths; with both the
    listener speaks HTTPS (TLS 1.2+, handshake in the connection's thread).
    """
    import hmac
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    use_tls = bool(tls_cert and tls_key)

    class Handler(BaseHTTPRequestHandler):
        def setup(self):
            # The TLS handshake runs in this connection's handler thread, so
            # one idle client cannot block serve_forever's accept loop.
            if use_tls:
                self.request.settimeout(15)
                try:
                    self.request.do_handshake()
                except OSError:
                    raise ConnectionAbortedError("TLS handshake failed")
                self.request.settimeout(None)
            super().setup()

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            got = self.headers.get("Authorization", "")
            return hmac.compare_digest(got, f"Bearer {auth_token}")

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, json.dumps(engine.stats()).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            parsed = urlparse(self.path)
            op = parsed.path.strip("/")
            if op not in ("encode", "decode", "reconstruct"):
                self._send(404, b"unknown op", "text/plain")
                return
            if not self._authorized():
                self._send(401, b"unauthorized", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > max_request_bytes:
                    self._send(413, f"request body {n} bytes > limit "
                               f"{max_request_bytes}".encode(), "text/plain")
                    return
                arr = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                # ?dtype=uint8|float16 encodes the result on the device.
                want = parse_qs(parsed.query).get("dtype", [None])[0]
                if want not in (None, "uint8", "float16"):
                    raise ValueError(f"bad dtype {want!r}")
                if op == "encode" and want == "uint8":
                    raise ValueError("encode supports dtype=float16 only")
                if arr.dtype != np.uint8:  # uint8 uploads stay uint8
                    arr = np.asarray(arr, np.float32)
                out = engine.submit(op, arr, want)
                buf = io.BytesIO()
                np.save(buf, out)
                self._send(200, buf.getvalue(), "application/octet-stream")
            except EngineOverloaded as e:
                self._send(503, str(e).encode(), "text/plain")
            except Exception as e:  # noqa: BLE001
                self._send(400, f"{type(e).__name__}: {e}".encode(), "text/plain")

    class _Server(ThreadingHTTPServer):
        def handle_error(self, request, client_address):
            import sys

            if isinstance(sys.exc_info()[1], (ConnectionError, TimeoutError, OSError)):
                return  # failed/idle TLS handshakes are not server errors
            super().handle_error(request, client_address)

    server = _Server((host, port), Handler)
    if use_tls:
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(certfile=tls_cert, keyfile=tls_key)
        server.socket = ctx.wrap_socket(server.socket, server_side=True,
                                        do_handshake_on_connect=False)
    return server
