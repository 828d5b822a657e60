"""Stage block stacks (PyTorch port of ``ops/stack.py``): the ``scan_blocks``
layout of TransVAE.

Within a stage every block has the same parameter shapes, so the JAX
package can hold a stage's blocks as one tensor per parameter with a
leading depth axis and run them as one ``lax.scan`` body
(``nn.scan(variable_axes={'params': 0})``). :class:`BlockStack` keeps that
layout: its state_dict keys are ``{encoder,decoder}.stages.{i}.scan.block.
<block path>`` with [depth, *shape] tensors, one-to-one with JAX's
``stage{i}_blocks/scan/block/...``. It computes what the unrolled blocks
compute, bit for bit: iteration j calls one block module on views of slice j
of every stack (``torch.func.functional_call``). What the layout changes is
what reads a parameter as one tensor: Adafactor's block-RMS clip covers a
whole stage's stack, as optax's does on the JAX stacked leaf.

:func:`stack_stage_params` / :func:`unstack_stage_params` and the
whole-model :func:`to_scanned_params` / :func:`from_scanned_params` convert
state_dicts (torch tensors or numpy arrays) between the unrolled
``stages.{i}.{j}.`` keys and the stacked ones.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..parallel.collectives import gather_from_group, rank_slice
from .blocks import run_block
from .layers import depth_slice


class BlockStack(nn.Module):
    """``depth`` blocks of ``block_cls(**block_kwargs)`` with stacked
    parameters under ``path`` (``scan.block``: the TransVAE stages; the
    DiT's is ``block``, JAX's ``blocks/block``). The forward runs the blocks
    in order on ``h``, each through ``run_block`` (so ``remat`` checkpoints
    each iteration under ``policy``, as ``nn.remat(Body)`` inside the JAX
    scan does), passing the forward's other arguments on to every block.

    Placed stacks: a stack that FSDP splits holds this rank's slice and is
    gathered whole once per forward (:meth:`hold_shard`, :meth:`stacks`),
    before the iterations, as XLA gathers the stacked leaf before its scan;
    a tensor-parallel stack holds this rank's slice of every block, which
    the modules' local-shard forwards take as it is; a pipeline stage holds
    its consecutive slices (:meth:`hold_slices`)."""

    def __init__(self, block_cls: type, block_kwargs: dict, depth: int, *,
                 remat: bool = False, policy=None, path: str = "scan.block", device=None):
        super().__init__()
        self.depth = depth  # the whole stack's depth
        self.held = range(depth)  # the slices this module holds
        self.remat, self.policy = remat, policy
        self.path = path
        self._make = functools.partial(block_cls, **{**block_kwargs, "device": "meta"})
        # {name in the block: (dim, group)} of the stacks FSDP split.
        self._shards: dict[str, tuple] = {}
        block = self._make()
        for module in block.modules():
            for store in (module._parameters, module._buffers):
                for name, t in store.items():
                    if t is None:
                        continue
                    stacked = torch.empty((depth, *t.shape), dtype=t.dtype, device=device)
                    store[name] = (nn.Parameter(stacked, requires_grad=t.requires_grad)
                                   if isinstance(t, nn.Parameter) else stacked)
        # One module of the block's class holds the stacks; each iteration
        # calls it on views of one slice.
        holder = self
        *outer, last = path.split(".")
        for name in outer:
            holder.add_module(name, nn.Module())
            holder = getattr(holder, name)
        holder.add_module(last, block)

    @property
    def template(self) -> nn.Module:
        """The module that holds the stacks."""
        return self.get_submodule(self.path)

    def _named(self) -> dict[str, torch.Tensor]:
        block = self.template
        return {**dict(block.named_parameters()), **dict(block.named_buffers())}

    def hold_shard(self, name: str, dim: int, group) -> None:
        """Keep this rank's slice along ``dim`` over ``group`` of stack
        ``name`` (its name in the block) and gather it whole in each forward:
        FSDP's placement of a stack (``parallel.shard_params``)."""
        owner, attr = _owner(self.template, name)
        full = getattr(owner, attr)
        setattr(owner, attr, nn.Parameter(rank_slice(full.detach(), dim, group),
                                          requires_grad=full.requires_grad))
        self._shards[name] = (dim, group)

    def hold_slices(self, slices: range) -> None:
        """Keep slices ``slices`` (consecutive) of every stack, in place (on
        the meta device too): a pipeline stage's part."""
        for name, t in self._named().items():
            owner, attr = _owner(self.template, name)
            part = t.detach()[slices.start:slices.stop].clone()
            setattr(owner, attr, nn.Parameter(part, requires_grad=t.requires_grad)
                    if isinstance(t, nn.Parameter) else part)
        self.held = range(self.held.start + slices.start, self.held.start + slices.stop)

    def stacks(self) -> dict[str, torch.Tensor]:
        """{name in the block: stack} of the held slices, whole along every
        other axis: an FSDP-split stack gathered over its group (one
        collective a stack and forward; its backward keeps this rank's slice
        of the gradient)."""
        out = self._named()
        for name, (dim, group) in self._shards.items():
            full = gather_from_group(out[name], dim, group)
            # CachedOperands keys derived operands on the shard's storage
            # and version (a gathered stack is new storage at each use).
            full._gathered_from = out[name]
            out[name] = full
        return out

    def unrolled(self, j: int) -> nn.Module:
        """Block ``j`` as a module of its own class whose parameters and
        buffers are views of slice ``j`` of the stacks: what it writes in
        place reaches the stacks (the seeded init, before any placement)."""
        with torch.device("meta"):
            block = self._make()
        block.load_state_dict({n: t[j] for n, t in self._named().items()},
                              strict=True, assign=True)
        return block

    def forward(self, h: torch.Tensor, *args) -> torch.Tensor:
        """The blocks in order on ``h``; ``args`` go to every block."""
        if len(self.held) != self.depth:
            raise RuntimeError(
                f"this stack holds slices [{self.held.start}, {self.held.stop}) of "
                f"{self.depth}, one pipeline stage's (PipelinePlacement.shard): run it "
                f"under its pipe group (parallel.mesh.use_axes)")
        # One unbind per stack and forward: its backward stacks the slices'
        # gradients once (indexing would add a zero stack per slice).
        slices = {}
        for n, t in self.stacks().items():
            slices[n] = t.unbind(0)
            src = getattr(t, "_gathered_from", None)
            for s in slices[n] if src is not None else ():
                s._gathered_from = src
        for j in range(self.depth):
            step = functools.partial(_run_slice, self.template,
                                     {n: s[j] for n, s in slices.items()}, j)
            h = run_block(step, h, *args, remat=self.remat, policy=self.policy)
        return h


def _owner(module: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (module.get_submodule(path) if path else module), attr


def _run_slice(block: nn.Module, tensors: dict, j: int, x: torch.Tensor, *args):
    """``block`` on slice ``j``'s tensors; the cached operands of its modules
    are kept per slice (``layers.depth_slice``), also in a checkpoint's
    recompute."""
    with depth_slice(j):
        return functional_call(block, tensors, (x, *args))


def stage_prefixes(config) -> list[tuple[str, int]]:
    """(state_dict prefix, depth) of every stage: the encoder's in
    ``config.depths`` order, the decoder's reversed."""
    return ([(f"encoder.stages.{i}", d) for i, d in enumerate(config.depths)]
            + [(f"decoder.stages.{i}", d) for i, d in enumerate(reversed(config.depths))])


def _stack(values: list) -> Any:
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return np.stack([np.asarray(v) for v in values])


def stack_stage_params(sd: Mapping[str, Any], prefix: str, depth: int) -> dict:
    """The unrolled keys ``{prefix}.{j}.<path>`` (j < depth) of a state_dict
    stacked into ``{prefix}.scan.block.<path>`` [depth, ...], in the place
    of block 0's keys; a new dict, ``sd`` untouched (its other entries are
    the same objects: copy before assigning them to a second model)."""
    head = prefix + "."
    blocks: dict[str, list] = {}
    order: list = []
    for k, v in sd.items():
        j, _, rest = k[len(head):].partition(".") if k.startswith(head) else ("", "", "")
        if j.isdigit() and int(j) < depth:
            if rest not in blocks:
                blocks[rest] = [None] * depth
                order.append(("stack", rest))
            blocks[rest][int(j)] = v
        else:
            order.append(("keep", k))
    out = {}
    for kind, k in order:
        if kind == "keep":
            out[k] = sd[k]
            continue
        if any(v is None for v in blocks[k]):
            raise KeyError(f"{prefix}: {k} is missing in some of the {depth} blocks")
        out[f"{prefix}.scan.block.{k}"] = _stack(blocks[k])
    return out


def unstack_stage_params(sd: Mapping[str, Any], prefix: str, depth: int) -> dict:
    """Inverse of :func:`stack_stage_params`: each ``{prefix}.scan.block.
    <path>`` split into ``{prefix}.{j}.<path>`` (views of its slices), in
    block order, in the place of the stacks."""
    head = f"{prefix}.scan.block."
    stacked = {k[len(head):]: v for k, v in sd.items() if k.startswith(head)}
    for rest, v in stacked.items():
        if len(v) != depth:
            raise ValueError(f"{head}{rest}: {len(v)} slices, depth {depth}")
    out = {}
    for k, v in sd.items():
        if not k.startswith(head):
            out[k] = v
        elif k[len(head):] == next(iter(stacked)):
            out.update({f"{prefix}.{j}.{rest}": s[j] for j in range(depth)
                        for rest, s in stacked.items()})
    return out


def to_scanned_params(sd: Mapping[str, Any], config) -> dict:
    """A whole model's unrolled state_dict in the ``scan_blocks`` layout."""
    out = dict(sd)
    for prefix, depth in stage_prefixes(config):
        out = stack_stage_params(out, prefix, depth)
    return out


def from_scanned_params(sd: Mapping[str, Any], config) -> dict:
    """A whole model's ``scan_blocks`` state_dict unrolled."""
    out = dict(sd)
    for prefix, depth in stage_prefixes(config):
        out = unstack_stage_params(out, prefix, depth)
    return out


def is_scanned(sd: Mapping[str, Any]) -> bool:
    """Whether a TransVAE state_dict holds the ``scan_blocks`` layout."""
    return any(".scan.block." in k for k in sd)
