"""Serving CLI: batched TransVAE inference over HTTP (npy payloads), bf16 on
one CUDA device (PyTorch port of ``cli/serve.py``).

Usage:
  python -m deepl_project_tpu_torch.cli.serve --checkpoint model.pt --port 8471
  python -m deepl_project_tpu_torch.cli.serve --variant tiny     # random init

``--checkpoint`` takes a reference-layout ``.pt`` file, as
``scripts/export_to_torch.py`` writes it from a JAX checkpoint. Int8 serving
and multi-device meshes are not ported yet: ``--quantize int8`` and
``--mesh_model > 1`` exit with a message.
"""

from __future__ import annotations

import argparse
import os


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
                   help="tensor-parallel serving: not yet ported (must be 1)")
    p.add_argument("--quantize", default="none", choices=["int8", "none"],
                   help="int8 serving is not yet ported; 'none' serves bf16")
    p.add_argument("--param_dtype", default=None, choices=["bfloat16"],
                   help="keep the parameters in bf16 (half the memory)")
    return p


def build_engine(args):
    """Model + InferenceEngine from parsed arguments."""
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
    return InferenceEngine(model, max_batch=args.max_batch,
                           batch_window_ms=args.batch_window_ms,
                           max_queue=args.max_queue)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if bool(args.tls_cert) != bool(args.tls_key):
        raise SystemExit("--tls_cert and --tls_key must be given together")
    if args.quantize == "int8":
        raise SystemExit("--quantize int8: not yet ported to deepl_project_tpu_torch")
    if args.mesh_model > 1:
        raise SystemExit("--mesh_model > 1: not yet ported to deepl_project_tpu_torch")

    from ..serving import make_http_server

    engine = build_engine(args)
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
          f"{args.port} (device {engine.stats()['device']}, "
          f"auth {'on' if token else 'off'})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
