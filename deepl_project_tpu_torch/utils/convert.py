"""Weights from the JAX package's param pytree into the port (the port's own
copy of ``deepl_project_tpu/utils/convert.py::params_to_torch_state_dict``).

The JAX tree (numpy leaves) maps onto the reference's state_dict layout,
which is the port's: HWIO conv kernels -> OIHW, [in, out] dense kernels ->
[out, in], ``scale`` -> ``weight``, stage{i}_block{j} -> stages.i.j,
down{i}/up{i} -> downsamples.i/upsamples.i with the reference's
nn.Sequential indices, conv_0/1/2 -> conv.0/2/4, conv_dw -> conv.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _seq_name(sub: str, name: str) -> str:
    """Resample submodule -> the reference's nn.Sequential index (Downsample
    main_path = [conv, act, conv] -> 0/2; Upsample = [up, conv, act, conv]
    -> 1/3)."""
    if sub.startswith("down"):
        return {"main_0": "main_path.0", "main_1": "main_path.2"}[name]
    return {"main_0": "main_path.1", "main_1": "main_path.3"}[name]


def params_to_torch_state_dict(params: Mapping[str, Any]) -> dict:
    """The JAX model params (the tree under {'params': ...}) as a
    reference-layout state_dict of numpy arrays."""
    flat: dict[tuple, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat[path] = np.asarray(node)

    walk(params, ())

    out: dict[str, np.ndarray] = {}
    for path, tensor in flat.items():
        leaf = path[-1]
        if leaf == "kernel":
            torch_leaf = "weight"
            tensor = (np.ascontiguousarray(np.transpose(tensor, (3, 2, 0, 1)))
                      if tensor.ndim == 4 else np.ascontiguousarray(tensor.T))
        elif leaf == "scale":
            torch_leaf = "weight"
        elif leaf == "bias":
            torch_leaf = "bias"
        else:
            raise ValueError(f"Unexpected param leaf {'.'.join(path)}")

        mods = []
        for name in path[:-1]:
            if name.startswith("stage") and "_block" in name:
                i, j = name[5:].split("_block")
                mods += ["stages", i, j]
            elif name.startswith("down"):
                mods += ["downsamples", name[4:]]
            elif name.startswith("up") and name[2:].isdigit():
                mods += ["upsamples", name[2:]]
            elif name in ("main_0", "main_1"):
                mods.append(_seq_name(path[1], name))
            elif name == "conv_dw":
                mods.append("conv")
            elif name in ("conv_0", "conv_1", "conv_2"):
                mods.append({"conv_0": "conv.0", "conv_1": "conv.2",
                             "conv_2": "conv.4"}[name])
            else:
                mods.append(name)
        out[".".join(mods + [torch_leaf])] = tensor
    return out


@torch.no_grad()
def load_state_dict(model: torch.nn.Module, state_dict: Mapping[str, Any]):
    """Load a state_dict (tensors or numpy arrays) into ``model`` with
    ``strict=True``, each tensor in the dtype and on the device of the
    parameter it replaces."""
    own = model.state_dict()
    sd = {}
    for k, v in state_dict.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        sd[k] = t.to(device=own[k].device, dtype=own[k].dtype) if k in own else t
    model.load_state_dict(sd, strict=True)
    return model


def load_jax_params(model: torch.nn.Module, params_np: Mapping[str, Any]):
    """Load the JAX package's param pytree (numpy leaves) into ``model``."""
    return load_state_dict(model, params_to_torch_state_dict(params_np))


def load_reference_checkpoint(model: torch.nn.Module, path: str):
    """Load a reference-layout ``.pt`` file (``{'model_state_dict': ...}`` as
    ``scripts/export_to_torch.py`` writes it, or a bare state_dict)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw
    return load_state_dict(model, {k.replace("module.", ""): v for k, v in sd.items()})
