"""Serving CLI: batched TransVAE inference over HTTP (npy payloads) on one
CUDA device or a mesh of them, bf16 or int8 (PyTorch port of
``cli/serve.py``).

Usage:
  python -m deepl_project_tpu_torch.cli.serve --checkpoint model.pt --port 8471
  python -m deepl_project_tpu_torch.cli.serve --variant tiny     # random init
  python -m deepl_project_tpu_torch.cli.serve --quantize int8 --quantize_scope all

``--checkpoint`` takes a reference-layout ``.pt`` file, as
``scripts/export_to_torch.py`` writes it from a JAX checkpoint.
``--quantize int8`` serves the int8 post-training-quantized model
(``quantize.quantize_model``) at ``--quantize_scope``, calibrated on 8
synthetic shapes images (two batches of 4) at ``--warmup_resolution`` or
256px; ``--quantize`` unset serves the float model (:func:`resolve_quantize`).

On a mesh, under torchrun (one process a rank; the process group joined
with ``parallel.initialize_multihost``, NCCL on CUDA, gloo with ``--device
cpu``), the ranks form a (data, 1, ``--mesh_model``) mesh and
``--mesh_sharding`` places the parameters (int8: replicated). Only global
rank 0 binds the port; the other ranks follow it
(``InferenceEngine.follow``):

  python -m torch.distributed.run --standalone --nproc_per_node 4 \
      -m deepl_project_tpu_torch.cli.serve --variant huge --mesh_model 2 \
      --mesh_sharding tensor --param_dtype bfloat16

``--mesh_model > 1`` outside torchrun exits with a message.
"""

from __future__ import annotations

import argparse
import os
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve TransVAE inference (PyTorch, CUDA)")
    p.add_argument("--checkpoint", default=None,
                   help="reference-layout .pt file; omit for random init of "
                        "--variant (testing)")
    p.add_argument("--variant", default="tiny")
    p.add_argument("--compression_ratio", type=int, default=16)
    p.add_argument("--latent_dim", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--batch_window_ms", type=float, default=3.0)
    p.add_argument("--warmup_resolution", type=int, default=0,
                   help="if set, run encode/decode/reconstruct across the "
                        "batch-bucket ladder at this resolution before "
                        "accepting traffic")
    p.add_argument("--warmup_ops", default="encode,decode,reconstruct")
    p.add_argument("--warmup_dtypes", default="float32",
                   help="comma-separated response encodings to warm "
                        "(float32, float16, uint8)")
    p.add_argument("--warmup_uint8_inputs", action="store_true")
    p.add_argument("--tls_cert", default=None)
    p.add_argument("--tls_key", default=None)
    p.add_argument("--auth_token", default=None,
                   help="require 'Authorization: Bearer <token>' on POSTs; "
                        "also read from DEEPL_SERVE_TOKEN")
    p.add_argument("--max_request_mb", type=int, default=64)
    p.add_argument("--max_queue", type=int, default=256)
    p.add_argument("--mesh_model", type=int, default=1,
                   help="multi-device serving (under torchrun): tensor-parallel "
                        "axis size; the remaining ranks form a data axis that "
                        "fans batches out (1 = single device)")
    p.add_argument("--mesh_sharding", default="tensor",
                   choices=["tensor", "fsdp", "replicate"],
                   help="param placement on the serving mesh")
    p.add_argument("--quantize", default=None, choices=["int8", "none"],
                   help="post-training int8 quantization of the served model "
                        "at --quantize_scope. Unset: 'none' (resolve_quantize; "
                        "the JAX package's unset is int8 on one device, but on "
                        "an H100 the int8 path is slower: reconstruct b32 "
                        "@256px of large f16d32 at 45.7 img/s at scope "
                        "resblock against 82.9 img/s bf16 on an NVIDIA H100 "
                        "80GB HBM3 at 700 W, PERF.md). 'none' serves the "
                        "float model")
    p.add_argument("--quantize_scope", default="resblock",
                   choices=["all", "resblock", "ffn"],
                   help="module families int8 covers: the ResBlock convs, "
                        "the ConvFFN matmuls and conv, or both")
    p.add_argument("--param_dtype", default=None, choices=["bfloat16"],
                   help="keep the parameters in bf16 (half the memory)")
    return p


def resolve_quantize(quantize: str | None, mesh_model: int) -> str:
    """The serving default. The JAX package's signature; its rule is int8 on
    one device (faster on a TPU) and the float model on a mesh. The port's
    unset resolves to the float model on any mesh: the int8 path of
    ``ops/quant.py`` (torch ops around ``torch._int_mm``) is slower than bf16
    on an H100 at every scope (PERF.md, section 6). An explicit
    choice is kept."""
    del mesh_model  # the float model either way
    return "none" if quantize is None else quantize


def quantize_for_serving(model, scope: str, resolution: int):
    """The int8 twin of ``model``, calibrated as the JAX server calibrates:
    8 synthetic shapes images (seed 0) at ``resolution``, two batches of 4."""
    import numpy as np

    from ..data.datasets import synthetic_shapes_dataset
    from ..quantize import quantize_model

    imgs = list(synthetic_shapes_dataset(resolution, num_samples=8, seed=0))
    return quantize_model(model, [np.stack(imgs[j:j + 4]) for j in (0, 4)], scope=scope)


def build_engine(args, mesh=None):
    """Model + InferenceEngine from parsed arguments, on ``mesh`` (a
    (data, 1, model) mesh of a joined process group) when given."""
    import torch

    from ..models import create_transvae, resolve_device
    from ..serving import InferenceEngine
    from ..utils.convert import load_reference_checkpoint

    device = resolve_device(args.device)
    extra = {"param_dtype": args.param_dtype} if args.param_dtype else {}
    if args.checkpoint:
        # The file's "config" names the variant (and may override fields).
        meta = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
        spec = dict(meta.get("config", {})) if isinstance(meta, dict) else {}
        model = create_transvae(spec.pop("variant", args.variant),
                                spec.pop("compression_ratio", args.compression_ratio),
                                spec.pop("latent_dim", args.latent_dim),
                                device=device, seed=None, **spec, **extra)
        load_reference_checkpoint(model, args.checkpoint)
    else:
        model = create_transvae(args.variant, args.compression_ratio,
                                args.latent_dim, device=device, seed=0, **extra)
        print("[serve] WARNING: no --checkpoint; serving random weights")
    quantize = resolve_quantize(args.quantize, args.mesh_model)
    if quantize == "int8":
        res = args.warmup_resolution or 256
        model = quantize_for_serving(model, args.quantize_scope, res)
        print(f"[serve] int8-quantized scope={args.quantize_scope} (calibrated on "
              f"synthetic batches at {res}px)")
    sharding = args.mesh_sharding
    if mesh is not None:
        if quantize == "int8":
            # The int8 modules hold buffers, not the parameters the tensor
            # and FSDP placements split: replicate them.
            sharding = "replicate"
        print(f"[serve] multi-chip mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
              f"params={sharding}")
    return InferenceEngine(model, max_batch=args.max_batch,
                           batch_window_ms=args.batch_window_ms,
                           max_queue=args.max_queue, mesh=mesh, param_sharding=sharding)


def join_mesh(args):
    """Under torchrun: join the process group (this rank's device into
    ``args.device``) and return the (data, 1, ``--mesh_model``) mesh; None
    outside it."""
    from ..parallel import create_mesh, initialize_multihost, under_torchrun

    if not under_torchrun():
        return None
    args.device = str(initialize_multihost(device=args.device)["device"])
    return create_mesh(model=args.mesh_model)


def serve(args, mesh=None):
    """(engine, server): the engine built (on ``mesh``, whose process group
    the caller has joined) and warmed; on global rank 0 (or without a mesh)
    its dispatcher started and an HTTP server bound to it (not yet
    serving), elsewhere None for the server: that rank calls
    ``engine.follow()``."""
    from ..serving import make_http_server

    engine = build_engine(args, mesh)
    if mesh is not None and engine.rank != 0:
        return engine, None
    if args.warmup_resolution:
        ops = tuple(o for o in args.warmup_ops.split(",") if o)
        dts = tuple(None if d in ("float32", "") else d
                    for d in args.warmup_dtypes.split(","))
        engine.warmup(args.warmup_resolution, ops=ops, dtypes=dts,
                      uint8_inputs=args.warmup_uint8_inputs)
        print(f"[serve] warmed up {ops} at {args.warmup_resolution}px "
              f"across batch buckets up to {args.max_batch}")
    engine.start()
    token = args.auth_token or os.environ.get("DEEPL_SERVE_TOKEN") or None
    server = make_http_server(engine, args.host, args.port, auth_token=token,
                              max_request_bytes=args.max_request_mb << 20,
                              tls_cert=args.tls_cert, tls_key=args.tls_key)
    scheme = "https" if args.tls_cert else "http"
    print(f"[serve] {engine.model.config.variant} on {scheme}://{args.host}:"
          f"{server.server_address[1]} (device {engine.stats()['device']}, "
          f"auth {'on' if token else 'off'})", flush=True)
    return engine, server


def run_server(engine, server) -> None:
    """Serve until interrupted, or until a mesh engine fails (then exit
    non-zero: its followers may be inside a collective); stop the engine."""
    def watch():
        while not done.wait(1.0):
            if engine.failed is not None:
                server.shutdown()
                return

    done = threading.Event()
    threading.Thread(target=watch, daemon=True).start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        done.set()
        server.server_close()
        engine.stop()
    if engine.failed is not None:
        raise SystemExit(f"[serve] the mesh engine failed: {engine.failed}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if bool(args.tls_cert) != bool(args.tls_key):
        raise SystemExit("--tls_cert and --tls_key must be given together")
    from ..parallel import under_torchrun

    if args.mesh_model > 1 and not under_torchrun():
        raise SystemExit(f"--mesh_model {args.mesh_model} needs a model group of that many "
                         "ranks: launch under torchrun (python -m torch.distributed.run)")
    mesh = join_mesh(args)
    engine, server = serve(args, mesh)
    if server is None:
        engine.follow()
    else:
        run_server(engine, server)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
