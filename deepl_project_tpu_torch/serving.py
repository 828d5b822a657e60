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

On a mesh (``mesh``: ``parallel.create_mesh``'s (data, context=1, model)
over the ranks of a process group, one process a rank, as torchrun starts
them), the constructor places the parameters with ``parallel.shard_params``
(``param_sharding``: 'tensor', the default, 'fsdp' or 'replicate'). Global
rank 0 owns the HTTP front end, the queue, the dispatcher and the fetch
thread; every other rank runs :meth:`InferenceEngine.follow`. For each
group it runs, rank 0 validates the batch, then broadcasts a header (op,
output encoding, uint8 input, bucketed shape) and the bucketed payload over
the default group; every rank takes its rows (``parallel.serving_rows``:
a block of the bucketed batch where its size divides ``data``, else the
whole batch) and runs the forward, so that every collective of the model
runs on every rank in the same order; the outputs are gathered over the
data group and rank 0 keeps the first rows. ``stop()`` on rank 0
broadcasts a stop header, on which the followers leave ``follow()``; an
idle dispatcher broadcasts a heartbeat header every ``HEARTBEAT_S``
seconds, so an idle follower never reaches the process group's timeout. The headers and payloads travel on the host
over gloo and on the engine's stream over NCCL, where the payload stays
on the device for the forward.

The collective rule: on each rank exactly one thread issues collectives
at a time, and the same sequence on every rank. On rank 0 that is the
dispatcher while it runs (``run`` / ``warmup`` from any other thread then
raise), or the one caller of ``run`` / ``warmup`` while it is stopped (a
second concurrent caller raises); on a follower the caller of ``follow``.
A failure is not carried on: any collective of rank 0 that raises (a
group's header, payload or forward, a heartbeat, the stop header) leaves
the engine failed (``failed``): the dispatcher fails the queued requests
and leaves its loop, every later request raises and no stop header is
sent. One on a follower raises out of ``follow``. A rank that leaves
breaks the others' next collective; the process group's timeout bounds
the ranks left waiting in one.

Endpoints:
  GET  /healthz      -> JSON status
  POST /encode       -> npy [B,H,W,3] in [0,1] (or uint8) -> npy mu [B,h,w,D]
  POST /decode       -> npy [B,h,w,D] latents -> npy images [B,H,W,3] in [0,1]
  POST /reconstruct  -> npy [B,H,W,3] -> npy images [B,H,W,3] (encode->mu->decode)
"""

from __future__ import annotations

import contextlib
import io
import json
import queue
import threading
import time

import numpy as np
import torch

OPS = ("encode", "decode", "reconstruct")
ENCODINGS = (None, "uint8", "float16")
# Header op codes besides the index of an op in OPS.
_STOP, _HEARTBEAT = -1, -2
HEARTBEAT_S = 30.0


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
    """Dynamic batcher around one TransVAE model (eval mode, inference
    only); on a ``mesh``, one rank's part of it (module docstring)."""

    def __init__(self, model, max_batch: int = 32, batch_window_ms: float = 3.0,
                 max_queue: int = 256, mesh=None, param_sharding: str = "tensor"):
        self.model = model.eval()
        self.mesh, self.placement = mesh, None
        if mesh is not None:
            import torch.distributed as dist

            from .parallel.sharding import shard_params

            self.placement = shard_params(mesh, self.model, param_sharding)
            self.rank = dist.get_rank()
            # Broadcasts of the headers and payloads: NCCL takes CUDA
            # tensors only; gloo host tensors (no staging).
            self._wire = (next(model.parameters()).device
                          if dist.get_backend() == "nccl" else torch.device("cpu"))
        self._collective = threading.Lock()
        self._released = False  # rank 0 sent the stop header
        self.failed: str | None = None
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
        waits for the result (padded rows included). On a mesh, rank 0 only:
        the batch is validated, broadcast and computed on every rank."""
        b = arr.shape[0]
        bb = _next_pow2(b, self.max_batch)
        assert bb >= b, (b, self.max_batch)
        if bb != b:
            arr = np.concatenate([arr, np.zeros((bb - b,) + arr.shape[1:], arr.dtype)])
        if arr.dtype != np.uint8:
            arr = np.asarray(arr, np.float32)
        if self.mesh is not None:
            return self._lead(op, arr, out_dtype)
        self._warm.add((op, out_dtype, arr.dtype == np.uint8) + arr.shape)
        return self._group(op, torch.from_numpy(arr), out_dtype)

    def run(self, op: str, arr: np.ndarray, out_dtype: str | None = None) -> np.ndarray:
        """Run one already-batched array (pads to the bucket; splits batches
        larger than max_batch)."""
        b = arr.shape[0]
        if b > self.max_batch:
            return np.concatenate([self.run(op, arr[i:i + self.max_batch], out_dtype)
                                   for i in range(0, b, self.max_batch)], axis=0)
        return self.run_async(op, arr, out_dtype).numpy()[:b]

    # -- the ranks of a mesh ----------------------------------------------
    def validate(self, op: str, arr: np.ndarray, out_dtype: str | None) -> None:
        """Raise ValueError for a request the model would refuse: on a mesh
        rank 0 checks it before anything goes out to the followers."""
        cfg = self.model.config
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        if out_dtype not in ENCODINGS:
            raise ValueError(f"bad dtype {out_dtype!r}")
        if op == "encode" and out_dtype == "uint8":
            raise ValueError("encode supports dtype=float16 only")
        channels = cfg.latent_dim if op == "decode" else 3
        if arr.ndim != 4 or arr.shape[-1] != channels or 0 in arr.shape:
            raise ValueError(f"{op} takes [B, H, W, {channels}] arrays, got {arr.shape}")
        f = 1 if op == "decode" else cfg.compression_ratio
        if arr.shape[1] % f or arr.shape[2] % f:
            raise ValueError(f"{op}: H and W must be multiples of {f}, got {arr.shape}")

    def _check_caller(self) -> None:
        if self.rank != 0:
            raise RuntimeError("on a mesh only global rank 0 runs requests; the other "
                               "ranks follow()")
        if self._thread is not None and threading.current_thread() is not self._thread:
            raise RuntimeError("on a mesh only the dispatcher issues collectives while it "
                               "runs: submit() the request, or stop() the dispatcher")

    @contextlib.contextmanager
    def _collectives(self, wait: bool = False):
        """Hold this rank's right to issue collectives (``wait``: block for
        it, else refuse a second caller). Anything raised inside leaves the
        engine failed: the followers may be inside one of its collectives,
        so nothing more goes out."""
        if not self._collective.acquire(blocking=wait):
            raise RuntimeError("on a mesh one thread issues collectives at a time: run() "
                               "and warmup() take one caller while the dispatcher is stopped")
        try:
            if self.failed is not None:
                raise RuntimeError(f"the mesh engine failed: {self.failed}")
            yield
        except BaseException as e:
            if self.failed is None:
                self.failed = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._collective.release()

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (rank 0's) broadcast over the default group: a host tensor
        over gloo, a device tensor on the engine's stream over NCCL."""
        import torch.distributed as dist

        with self._on_wire():
            wire = t.to(self._wire)
            dist.broadcast(wire, 0)
        return wire

    def _on_wire(self):
        """The stream the broadcasts (and a read of their result) run on."""
        return (torch.cuda.stream(self.stream) if self._wire.type == "cuda"
                else contextlib.nullcontext())

    def _send_header(self, op: int, out_dtype: str | None = None, uint8: bool = False,
                     shape: tuple = (0, 0, 0, 0)) -> None:
        self._broadcast(torch.tensor([op, ENCODINGS.index(out_dtype), int(uint8), *shape],
                                     dtype=torch.int64))

    def _lead(self, op: str, arr: np.ndarray, out_dtype: str | None) -> _Pending:
        """Rank 0's side of one group: validate, send the header and the
        payload, run the group (:meth:`_group`)."""
        self._check_caller()
        self.validate(op, arr, out_dtype)
        with self._collectives():
            self._send_header(OPS.index(op), out_dtype, arr.dtype == np.uint8, arr.shape)
            self._warm.add((op, out_dtype, arr.dtype == np.uint8) + arr.shape)
            return self._group(op, self._broadcast(torch.from_numpy(arr)), out_dtype)

    def _group(self, op: str, payload: torch.Tensor, out_dtype: str | None,
                keep: bool = True) -> _Pending | None:
        """One group on this rank: on a mesh its rows of the bucketed
        payload, the forward, the outputs gathered over the data group; with
        ``keep`` (one process, or rank 0 of a mesh) a handle to them on the
        host."""
        from torch.nn.utils import parametrize

        from .parallel.collectives import all_gather_cat
        from .parallel.mesh import serving_rows

        rows = None if self.mesh is None else serving_rows(self.mesh, payload.shape[0])
        # The collectives run on the engine's stream: gloo stages CUDA
        # tensors through the host on the current stream, and an NCCL
        # payload arrived on it. parametrize.cached: an FSDP weight is
        # gathered once a forward, not at each read (the sublayer route
        # reads q/k/v and the projection for the kernels' operands and for
        # their cache keys).
        on_stream = (torch.cuda.stream(self.stream) if self.stream is not None
                     else contextlib.nullcontext())
        with torch.inference_mode(), parametrize.cached(), on_stream:
            if rows is not None:
                payload = payload[torch.from_numpy(rows).to(payload.device)]
            y = self._compute(op, payload.to(self.device, non_blocking=True), out_dtype)
            if rows is not None:
                y = all_gather_cat(y, 0, self.placement.data_group)
            if not keep:
                return None
            if self.stream is None:
                return _Pending(y)
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            host.copy_(y, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return _Pending(host, event)

    def follow(self) -> None:
        """A follower's loop (every rank but global rank 0): run each group
        rank 0 broadcasts until its stop header. Raises on any failure."""
        if self.mesh is None or self.rank == 0:
            raise RuntimeError("follow() runs on the ranks of a mesh other than rank 0")
        while True:
            with self._on_wire():
                head = self._broadcast(torch.zeros(7, dtype=torch.int64)).tolist()
            if head[0] == _STOP:
                break
            if head[0] == _HEARTBEAT:
                continue
            payload = self._broadcast(torch.zeros(
                head[3:], dtype=torch.uint8 if head[2] else torch.float32))
            self._group(OPS[head[0]], payload, ENCODINGS[head[1]], keep=False)
        if self.stream is not None:
            self.stream.synchronize()

    def _heartbeat(self) -> None:
        """Broadcast a heartbeat header from the idle dispatcher, so that a
        follower waiting for the next header stays within the process
        group's timeout."""
        with self._collectives(wait=True):
            self._send_header(_HEARTBEAT)

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
        if self.failed is not None:
            raise RuntimeError(f"the mesh engine failed: {self.failed}")
        try:
            self._queue.put_nowait(((op, out_dtype), arr, ev, slot))
        except queue.Full:
            raise EngineOverloaded(f"request queue full ({self._queue.maxsize})") from None
        if self.failed is not None:
            # The dispatcher may have failed the queue before this request
            # went in: it leaves its loop once failed is set.
            self._fail_queued(f"the mesh engine failed: {self.failed}")
        ev.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def start(self):
        if self.mesh is not None and self.rank != 0:
            raise RuntimeError("on a mesh only global rank 0 runs the dispatcher")
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
        self._fail_queued("engine stopped")
        # The followers leave follow(), once; a failed engine sends nothing.
        if (self.mesh is not None and self.rank == 0 and not self._released
                and self.failed is None):
            self._released = True
            with self._collectives(wait=True):
                self._send_header(_STOP)

    def _fail_queued(self, error: str) -> None:
        while True:
            try:
                _, _, ev, slot = self._queue.get_nowait()
            except queue.Empty:
                return
            slot["error"] = error
            ev.set()

    def _dispatch_loop(self):
        carried = None  # an incompatible request heads the NEXT group
        last = time.monotonic()
        while not self._stop.is_set() and self.failed is None:
            if carried is not None:
                first, carried = carried, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    if self.mesh is not None and time.monotonic() - last > HEARTBEAT_S:
                        try:
                            self._heartbeat()
                        except Exception:  # noqa: BLE001 -- failed is set: leave the loop
                            break
                        last = time.monotonic()
                    continue
            last = time.monotonic()
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
        error = ("engine stopped" if self.failed is None
                 else f"the mesh engine failed: {self.failed}")
        if carried is not None:  # stop() or a failure raced a carried request
            carried[3]["error"] = error
            carried[2].set()
        if self.failed is not None:
            self._fail_queued(error)

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
        mesh = (None if self.mesh is None else
                dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape)))
        return {"device": dev, "mesh": mesh, "variant": self.model.config.variant,
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
