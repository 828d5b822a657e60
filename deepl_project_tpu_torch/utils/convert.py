"""Weights from the JAX package's param pytrees into the port: the model's
(the port's own copy of
``deepl_project_tpu/utils/convert.py::params_to_torch_state_dict``, which
also takes the int8 tree of ``quantize.quantize_params`` and the
``scan_blocks`` layout), the PatchGAN
discriminator's (:func:`disc_params_to_torch_state_dict`), LPIPS's
(:func:`lpips_params_from_jax`) and a trainer's {'model', 'vf_proj'} tree
(:func:`load_jax_train_params`; ``vf_proj`` keeps its layout, kernel [D, C]
and bias [C], as the port's ``vf_loss`` computes latent @ kernel), and the
latent DiT's (:func:`dit_params_to_torch_state_dict`; either layout, as
:func:`in_model_layout` converts TransVAE's).

The JAX tree (numpy leaves) maps onto the reference's state_dict layout,
which is the port's: HWIO conv kernels -> OIHW, [in, out] dense kernels ->
[out, in], ``scale`` -> ``weight``, stage{i}_block{j} -> stages.i.j,
down{i}/up{i} -> downsamples.i/upsamples.i with the reference's
nn.Sequential indices, conv_0/1/2 -> conv.0/2/4, conv_dw -> conv; in the
``scan_blocks`` layout stage{i}_blocks/scan/block -> stages.i.scan.block,
each leaf's leading depth axis kept and its other axes mapped as above
(``ops.stack`` converts the state_dict between the layouts). Int8
leaves keep their names, their kernels output channels first (HWIO ``kernel_q``
-> [out, kh, kw, in], [in, out] ``kernel_q``/``w_head_q``/``w_fold_q`` ->
[out, in]), as ``ops/quant.py`` stores them.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..ops.stack import from_scanned_params, is_scanned, to_scanned_params


def _seq_name(sub: str, name: str) -> str:
    """Resample submodule -> the reference's nn.Sequential index (Downsample
    main_path = [conv, act, conv] -> 0/2; Upsample = [up, conv, act, conv]
    -> 1/3)."""
    if sub.startswith("down"):
        return {"main_0": "main_path.0", "main_1": "main_path.2"}[name]
    return {"main_0": "main_path.1", "main_1": "main_path.3"}[name]


# Leaves of the int8 tree copied as they are (scales, biases of the fold).
_INT8_PLAIN = ("kernel_scale", "act_scale", "w_head_scale", "w_fold_scale",
               "act_scale_y", "act_scale_z2", "b0", "b_fold")


def _move(a: np.ndarray, lead: int, conv_axes) -> np.ndarray:
    """A kernel's axes in the port's order: a 4-D one permuted by
    ``conv_axes``, a 2-D one transposed, the ``lead`` leading (depth) axes
    kept."""
    nd = a.ndim - lead
    axes = conv_axes if nd == 4 else (1, 0)
    return np.ascontiguousarray(
        np.transpose(a, tuple(range(lead)) + tuple(x + lead for x in axes)))


def params_to_torch_state_dict(params: Mapping[str, Any]) -> dict:
    """The JAX model params (the tree under {'params': ...}, float or the
    int8 tree of ``quantize_params``) as a reference-layout state_dict of
    numpy arrays."""
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
        lead = 1 if "scan" in path else 0  # a stacked leaf's depth axis
        if leaf == "kernel":
            torch_leaf, tensor = "weight", _move(tensor, lead, (3, 2, 0, 1))
        elif leaf == "scale":
            torch_leaf = "weight"
        elif leaf == "kernel_q":
            torch_leaf, tensor = leaf, _move(tensor, lead, (3, 0, 1, 2))
        elif leaf in ("w_head_q", "w_fold_q"):
            torch_leaf, tensor = leaf, _move(tensor, lead, None)
        elif leaf == "bias" or leaf in _INT8_PLAIN:
            torch_leaf = leaf
        else:
            raise ValueError(f"Unexpected param leaf {'.'.join(path)}")

        mods = []
        for name in path[:-1]:
            if name.startswith("stage") and name.endswith("_blocks"):
                mods += ["stages", name[5:-7]]
            elif name.startswith("stage") and "_block" in name:
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


def in_model_layout(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> Mapping:
    """``state_dict`` in the block layout of ``model``: stacked for a
    TransVAE with ``scan_blocks`` or a stacked DiT (``scan_blocks`` or
    ``pipeline_axis``), unrolled for another (``ops.stack``,
    ``models.dit``); as it is for a model without the field."""
    from ..models.dit import DiT, is_stacked_dit, stack_dit_params, unstack_dit_params

    cfg = getattr(model, "config", None)
    if isinstance(model, DiT):
        if is_stacked_dit(state_dict) and not cfg.stacked:
            return unstack_dit_params(state_dict)
        if cfg.stacked and not is_stacked_dit(state_dict):
            return stack_dit_params(state_dict, cfg.depth)
        return state_dict
    scan = getattr(cfg, "scan_blocks", False)
    if is_scanned(state_dict) and not scan:
        return from_scanned_params(state_dict, cfg)
    if scan and not is_scanned(state_dict):
        return to_scanned_params(state_dict, cfg)
    return state_dict


def resume_in_model_layout(model: torch.nn.Module, optimizer: Mapping[str, Any],
                           ema: Mapping[str, Any] | None) -> tuple[dict | None, Mapping | None]:
    """A checkpoint's optimizer state and EMA shadow in the block layout of
    ``model`` (:func:`in_model_layout`; the trainers' one rule on resume).
    The EMA and AdamW's moments are per-element and convert exactly. An
    Adafactor state of the other layout comes back None: its moments are
    factored on the saved layout's shapes, so the caller starts the
    optimizer afresh."""
    moments = [k for k, v in optimizer.items() if isinstance(v, Mapping)]
    out = {k: in_model_layout(model, v) if k in moments else v for k, v in optimizer.items()}
    switched = any(out[k] is not optimizer[k] for k in moments)
    if switched and optimizer.get("kind", "adamw") == "adafactor":
        out = None
    return out, None if ema is None else in_model_layout(model, ema)


@torch.no_grad()
def load_state_dict(model: torch.nn.Module, state_dict: Mapping[str, Any]):
    """Load a state_dict (tensors or numpy arrays, either block layout:
    :func:`in_model_layout`) into ``model`` with ``strict=True``, each
    tensor in the dtype and on the device of the parameter it replaces."""
    own = model.state_dict()
    sd = {}
    for k, v in in_model_layout(model, state_dict).items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        sd[k] = t.to(device=own[k].device, dtype=own[k].dtype) if k in own else t
    model.load_state_dict(sd, strict=True)
    return model


# The JAX package's quantize_params tree converts by the same walk.
quantized_params_to_torch_state_dict = params_to_torch_state_dict


def load_jax_params(model: torch.nn.Module, params_np: Mapping[str, Any]):
    """Load the JAX package's param pytree (numpy leaves; float, int8, either
    layout) into ``model``, in the model's layout: a ``scan_blocks`` tree
    unrolled for an unrolled model, an unrolled one stacked for a
    ``scan_blocks`` model."""
    return load_state_dict(model, params_to_torch_state_dict(params_np))


def load_jax_train_params(model: torch.nn.Module, params_np: Mapping[str, Any]):
    """Load a JAX trainer's params ({'model': ..., and with a VF teacher
    'vf_proj': {'kernel': [D, C], 'bias': [C]}}, numpy leaves) into
    ``model``; returns the VF projection (``training.train_step.VFProj``) on
    the model's device, or None when the tree has none."""
    from ..training.train_step import VFProj

    load_jax_params(model, params_np["model"])
    if "vf_proj" not in params_np:
        return None
    tree = params_np["vf_proj"]
    kernel = np.asarray(tree["kernel"], np.float32)
    proj = VFProj(*kernel.shape, device=next(model.parameters()).device)
    return load_state_dict(proj, {"kernel": kernel, "bias": tree["bias"]})


def disc_params_to_torch_state_dict(params: Mapping[str, Any]) -> dict:
    """The JAX ``PatchDiscriminator``'s params ({'conv0': {'kernel', 'bias'},
    'conv1': {'kernel'}, 'norm1': {'scale', 'bias'}, ..., 'conv_out'}, numpy
    or array leaves) as the port's state_dict of numpy arrays: HWIO kernels
    -> OIHW ``weight``, ``scale`` -> ``weight``."""
    out: dict[str, np.ndarray] = {}
    for module, leaves in params.items():
        for leaf, value in leaves.items():
            a = np.asarray(value)
            if leaf == "kernel":
                out[f"{module}.weight"] = np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))
            elif leaf in ("scale", "bias"):
                out[f"{module}.{'weight' if leaf == 'scale' else 'bias'}"] = a
            else:
                raise ValueError(f"Unexpected discriminator param {module}.{leaf}")
    return out


def load_jax_disc_params(disc: torch.nn.Module, params_np: Mapping[str, Any]):
    """Load the JAX ``PatchDiscriminator``'s params into ``disc``."""
    return load_state_dict(disc, disc_params_to_torch_state_dict(params_np))


def load_reference_checkpoint(model: torch.nn.Module, path: str):
    """Load a reference-layout ``.pt`` file (``{'model_state_dict': ...}`` as
    ``scripts/export_to_torch.py`` writes it, or a bare state_dict; either
    block layout)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw
    return load_state_dict(model, {k.replace("module.", ""): v for k, v in sd.items()})


def lpips_params_from_jax(tree: Mapping[str, Any]) -> dict:
    """The port's LPIPS params from the JAX package's LPIPS tree or ``.npz``
    groups ({'conv': {w{i}: HWIO, b{i}}, 'lin': {w{i}}}, numpy or array
    leaves): fp32 tensors, conv kernels in OIHW."""
    out: dict = {"conv": {}, "lin": {}}
    for group, leaves in tree.items():
        for name, v in leaves.items():
            t = torch.from_numpy(np.array(v, np.float32))
            if group == "conv" and name.startswith("w"):
                t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            out[group][name] = t
    return out


def dit_params_to_torch_state_dict(params: Mapping[str, Any]) -> dict:
    """The JAX DiT's params (numpy or array leaves; flat ``block{i}`` or the
    stacked ``blocks/block`` layout, which stays stacked: ``blocks.block.
    <path>`` with its leading depth axis) as the port's state_dict of numpy
    arrays: module paths joined with '.', Dense kernels [in, out] ->
    ``weight`` [out, in], the HWIO patch conv -> OIHW, MoE expert kernels
    [E, in, out] -> [E, out, in]; biases, ``embedding`` and ``pos_embed`` as
    they are. The depth axis is read from the path (JAX's ``"scan" in
    names`` does not see this tree's)."""
    out: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        a = np.asarray(node)
        leaf = path[-1]
        if leaf == "kernel":
            leaf = "weight"
            lead = 1 if path[0] == "blocks" else 0  # the stack's depth axis
            axes = {2: (1, 0), 3: (0, 2, 1), 4: (3, 2, 0, 1)}[a.ndim - lead]
            a = np.transpose(a, tuple(range(lead)) + tuple(x + lead for x in axes))
        elif leaf not in ("bias", "embedding", "pos_embed"):
            raise ValueError(f"Unexpected DiT param {'.'.join(path)}")
        out[".".join(path[:-1] + (leaf,))] = np.ascontiguousarray(a)

    walk(params, ())
    return out


def load_jax_dit_params(model: torch.nn.Module, params_np: Mapping[str, Any]):
    """Load the JAX DiT's param tree (flat or stacked) into the port's
    ``models.dit.DiT`` with ``strict=True``, in the model's layout
    (:func:`in_model_layout`): a stacked tree into a stacked model as it
    is, unstacked for an unrolled one, and the other way round."""
    return load_state_dict(model, dit_params_to_torch_state_dict(params_np))
