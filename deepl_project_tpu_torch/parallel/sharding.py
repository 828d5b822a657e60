"""Parameter placement over the ``model`` axis: replicate, FSDP or tensor
parallel (PyTorch port of ``parallel/sharding.py``; its rules, kept here as
the port's own copy).

- ``replicate``: every rank holds every parameter; the gradients are
  averaged over ``data`` inside the step (what DDP's all-reduce did).
- ``fsdp``: every parameter of at least ``fsdp_min_size`` elements holds
  this rank's slice along its largest divisible dimension (ties: the first
  in the JAX layout); a ``torch.nn.utils.parametrize`` parametrization
  all-gathers the whole weight at each use, and its backward keeps this
  rank's slice of the gradient (every model peer holds it whole: they see
  the same rows). The rule reads a ``scan_blocks`` stack's whole shape, its
  depth axis one more axis; the stack is gathered whole once a forward
  (``ops.stack.BlockStack.hold_shard``), as XLA gathers the stacked leaf
  before its scan.
- ``tensor``: Megatron-style. Column parallel (output split): ``to_q``,
  ``to_k``, ``to_v``, ``proj_in``; row parallel (input split): ``proj``,
  ``proj_out``; column convolutions: the ConvFFN's ``conv_0`` and
  ``conv_2`` (the port's ``conv.0`` / ``conv.4``) and the ResBlock's
  ``conv1``; biases of column layers split with them. The modules that own
  them run their local-shard forwards (``ops/attention.py``,
  ``ops/ffn.py``, ``ops/blocks.py``) with the collectives of
  ``collectives.py``. A ``scan_blocks`` stack's leading depth axis is never
  split: each slice is this rank's part of one block.

The rules read the JAX layout of each parameter ([in, out] dense kernels,
HWIO convs; :func:`~deepl_project_tpu_torch.training.optim.jax_layout`) and
the placement is mapped back to the port's ([out, in], OIHW): every
parameter is placed as the JAX rule places it. Where the head count is not
a multiple of the model axis, ``to_q/to_k/to_v`` still hold width/m output
columns each and ``proj`` width/m input rows, which cuts a head; the
attention module then gathers q, k and v over the group for its core
(``ops.attention.AttentionRoPE.partial_heads``), as GSPMD does. No config
splits a ConvFFN's parameters in part (every width is a multiple of 128);
a module built so is refused by :func:`shard_params`.

:class:`Placement` carries the mesh's groups and the parameters'
placements by name, for the steps (the gradient all-reduce over the
parameter peers), the optimizer (norms and Adafactor's moments over sharded
dimensions) and checkpoints (whole tensors gathered over the model group on
save, written by global rank 0, the first rank of the first peer group; sliced
on restore).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from .collectives import all_gather_cat, all_reduce_sum, gather_from_group, rank_slice
from .mesh import CONTEXT_AXIS, DATA_AXIS, MODEL_AXIS, Replicate, Shard, axis_size

MODES = ("replicate", "fsdp", "tensor")
FSDP_MIN_SIZE = 2 ** 16

_COLUMN_PARALLEL = ("to_q", "to_k", "to_v", "proj_in")
_ROW_PARALLEL = ("proj", "proj_out")
_CONV_COLUMN = ("conv_0", "conv_2", "conv1")
# The port's module names of the ConvFFN's convs (the reference's
# nn.Sequential indices) -> the JAX package's.
_JAX_CONV_NAMES = {"0": "conv_0", "2": "conv_1", "4": "conv_2"}


def _jax_layout(name: str, shape) -> tuple[int, ...]:
    from ..training.optim import jax_layout

    return jax_layout(name, shape)


def _parent(name: str) -> str:
    parts = name.split(".")
    if len(parts) >= 3 and parts[-3] == "conv" and parts[-2] in _JAX_CONV_NAMES:
        return _JAX_CONV_NAMES[parts[-2]]
    return parts[-2] if len(parts) >= 2 else ""


def _tensor_axis(name: str, jax_shape: tuple, model_size: int) -> int | None:
    """The JAX rule's sharded axis (in the JAX layout) under 'tensor'. A
    name with a ``scan`` component (a TransVAE stage stack) carries a
    leading depth axis, never split: the rule reads the axes after it, as
    JAX's ``stacked``. The DiT's stacks (``blocks.block``) hold no such
    component, and JAX's rule reads their whole shape, which matches no
    case: they stay replicated, here as there."""
    leaf, parent = name.split(".")[-1], _parent(name)
    stacked = 1 if "scan" in name.split(".") else 0
    shape = jax_shape[stacked:]
    kernel = leaf == "weight" and len(shape) in (2, 4)
    axis = None
    if kernel and len(shape) == 2:
        if parent in _COLUMN_PARALLEL and shape[-1] % model_size == 0:
            axis = 1
        elif parent in _ROW_PARALLEL and shape[-2] % model_size == 0:
            axis = 0
    elif kernel and len(shape) == 4:
        if parent in _CONV_COLUMN and shape[-1] % model_size == 0:
            axis = 3
    elif (leaf == "bias" and len(shape) == 1 and parent in _COLUMN_PARALLEL + _CONV_COLUMN
          and shape[0] % model_size == 0):
        axis = 0
    return None if axis is None else stacked + axis


def _fsdp_axis(jax_shape: tuple, model_size: int, min_size: int) -> int | None:
    """JAX's FSDP rule on the whole JAX-layout shape (a stack's depth axis
    included: it is one more axis there, and the size threshold counts the
    whole stack)."""
    if math.prod(jax_shape) < min_size:
        return None
    for axis in sorted(range(len(jax_shape)), key=lambda i: -jax_shape[i]):
        if jax_shape[axis] % model_size == 0 and jax_shape[axis] >= model_size:
            return axis
    return None


def param_specs(module: nn.Module, mode: str = "replicate", model_size: int = 1,
                fsdp_min_size: int | None = None, prefix: str = "") -> dict:
    """The placement of each parameter of ``module`` by its state_dict key
    (``prefix`` + name): ``Replicate()`` or ``Shard(dim)`` in the port's
    layout, by the JAX package's ``param_specs`` rules."""
    if mode not in MODES:
        raise ValueError(f"Unknown sharding mode: {mode!r}")
    min_size = FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
    specs = {}
    for name, p in module.named_parameters():
        key = prefix + name
        axis = None
        if mode != "replicate" and model_size > 1:
            axes = _jax_layout(key, p.shape)
            jax_shape = tuple(p.shape[a] for a in axes)
            if mode == "fsdp":
                axis = _fsdp_axis(jax_shape, model_size, min_size)
            else:
                axis = _tensor_axis(key, jax_shape, model_size)
            axis = None if axis is None else axes[axis]
        specs[key] = Replicate() if axis is None else Shard(axis)
    return specs


def canonical_name(name: str) -> str:
    """A parameter's state_dict key without the parametrization's
    ``parametrizations.<name>.original`` wrapping."""
    if ".parametrizations." in name and name.endswith(".original"):
        head, tail = name.split(".parametrizations.", 1)
        return f"{head}.{tail[:-len('.original')]}"
    return name


class _GatherShard(nn.Module):
    """FSDP's parametrization: the whole weight from this rank's slice."""

    def __init__(self, dim: int, group):
        super().__init__()
        self.dim, self.group = dim, group

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        full = gather_from_group(shard, self.dim, self.group)
        # CachedOperands keys derived operands on this storage and version.
        full._gathered_from = shard
        return full

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return rank_slice(full, self.dim, self.group)


def _owner(module: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (module.get_submodule(path) if path else module), attr


def _peer_group(mesh):
    """The group of ranks that hold the same parameters: this rank's model
    coordinate, every (data, context) coordinate. Every rank makes every
    model coordinate's group, in order, as ``new_group`` requires."""
    ranks = mesh.mesh.reshape(-1, mesh.mesh.shape[-1])  # [(data, context), model]
    groups = [dist.new_group(ranks[:, m].tolist()) for m in range(ranks.shape[1])]
    return groups[mesh.get_local_rank(MODEL_AXIS)]


class Placement:
    """The mesh's data, context and model groups, the group of parameter
    peers (data x context: the ranks that hold the same parameters and
    average their gradients; the data group itself at context 1), and each
    parameter's placement (``specs``) and whole shape (``full_shapes``) by
    canonical name, which :func:`shard_params` fills; a name it does not
    hold is replicated."""

    def __init__(self, mesh, mode: str = "replicate"):
        self.mesh, self.mode = mesh, mode
        self.data_group = mesh.get_group(DATA_AXIS)
        self.context_group = mesh.get_group(CONTEXT_AXIS)
        self.model_group = mesh.get_group(MODEL_AXIS)
        self.data_size = axis_size(mesh, DATA_AXIS)
        self.context_size = axis_size(mesh, CONTEXT_AXIS)
        self.model_size = axis_size(mesh, MODEL_AXIS)
        self.data_rank = dist.get_rank(self.data_group)
        self.model_rank = dist.get_rank(self.model_group)
        self.peer_group = (self.data_group if self.context_size == 1
                           else _peer_group(mesh))
        self.specs: dict = {}
        self.full_shapes: dict = {}

    def dim(self, name: str) -> int | None:
        spec = self.specs.get(canonical_name(name))
        return spec.dim if isinstance(spec, Shard) else None

    @property
    def sharded(self) -> bool:
        return any(isinstance(s, Shard) for s in self.specs.values())

    def full_shape(self, name: str, local: torch.Tensor) -> tuple:
        return tuple(self.full_shapes.get(canonical_name(name), local.shape))

    def scatter(self, full: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's slice along ``dim`` of a whole tensor (``full``
        itself when None)."""
        return full if dim is None else rank_slice(full, dim, self.model_group)

    @torch.no_grad()
    def gather(self, local: torch.Tensor, dim: int | None) -> torch.Tensor:
        """The whole tensor from every model peer's slice along ``dim``
        (collective over the model group; ``local`` itself when None)."""
        return local if dim is None else all_gather_cat(local, dim, self.model_group)

    def sum_sharded(self, value: torch.Tensor) -> torch.Tensor:
        """An all-reduce (sum) of ``value`` over the model group."""
        return all_reduce_sum(value, self.model_group)

    def norm(self, tensors: list[torch.Tensor], names: list[str]) -> torch.Tensor:
        """The global L2 norm of tensors placed as ``names``: the squares of
        the sharded ones summed over the model group, the replicated ones
        counted once."""
        rep = [t for t, n in zip(tensors, names) if self.dim(n) is None]
        shard = [t for t, n in zip(tensors, names) if self.dim(n) is not None]
        zero = tensors[0].new_zeros((), dtype=torch.float32)
        sq = torch.stack(torch._foreach_norm(rep)).square().sum() if rep else zero
        if self.sharded:
            part = torch.stack(torch._foreach_norm(shard)).square().sum() if shard else zero
            sq = sq + self.sum_sharded(part)
        return sq.sqrt()

    def any_peer(self, flag: torch.Tensor) -> bool:
        """Whether the 0-d bool ``flag`` holds on any model peer (itself
        when nothing is sharded: the peers then hold the same values)."""
        if not self.sharded:
            return bool(flag)
        t = flag.float()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.model_group)
        return bool(t)

    def full_named(self, named: dict, dim_of) -> dict:
        """{name: whole tensor} of a {name: local tensor} dict whose tensor
        ``name`` is split along ``dim_of(name)`` (an optimizer's state)."""
        return {n: self.gather(t, dim_of(n)) for n, t in named.items()}

    def local_named(self, full: dict, names, dim_of) -> dict:
        """This rank's slices of a whole {name: tensor} dict."""
        return {n: self.scatter(full[n], dim_of(n)) for n in names}

    @torch.no_grad()
    def full_state(self, named, prefix: str = "") -> dict:
        """{canonical name: whole tensor} of (name, local tensor) pairs placed
        as ``prefix`` + name, gathered over the model group (every rank must
        call it)."""
        return {canonical_name(n): self.gather(t.detach(), self.dim(prefix + n))
                for n, t in named}

    @torch.no_grad()
    def load_full(self, named, full: dict, prefix: str = "") -> None:
        """Copy each whole tensor of ``full`` (keys: the canonical names of
        ``named``, exactly) into this rank's slice."""
        named = [(canonical_name(n), t) for n, t in named]
        if set(full) != {n for n, _ in named}:
            raise RuntimeError("state keys do not match the parameters: "
                               f"{sorted(set(full) ^ {n for n, _ in named})[:8]}")
        for n, t in named:
            t.copy_(self.scatter(full[n], self.dim(prefix + n)))


def shard_params(mesh, model: nn.Module, mode: str = "replicate",
                 fsdp_min_size: int | None = None, prefix: str = "",
                 placement: Placement | None = None) -> Placement:
    """Place ``model``'s parameters (whole, identical on every rank) on the
    mesh under ``mode``, in place, and return their :class:`Placement`
    (``placement``, extended, when given: several modules under one).
    'fsdp' registers the gathering parametrization on each split weight,
    or, for a stage stack's, has its ``ops.stack.BlockStack`` hold this
    rank's slice and gather it once a forward; 'tensor' replaces each split
    parameter by this rank's slice and hands the model group to the modules
    that own them (a stack's template modules too: each slice is then this
    rank's part of one block). Under every mode a model axis of more than
    one rank hands its group to each module with dropout
    (``dropout_group``)."""
    model_size = axis_size(mesh, MODEL_AXIS)
    specs = param_specs(model, mode, model_size, fsdp_min_size, prefix)
    if placement is None:
        placement = Placement(mesh, mode)
    placement.specs.update(specs)
    placement.full_shapes.update({prefix + n: tuple(p.shape)
                                  for n, p in model.named_parameters()})
    group = placement.model_group
    from ..ops.stack import BlockStack

    stacks = {f"{prefix}{n + '.' if n else ''}{m.path}.": m for n, m in model.named_modules()
              if isinstance(m, BlockStack)}
    for key, spec in specs.items():
        if not isinstance(spec, Shard):
            continue
        owner, attr = _owner(model, key[len(prefix):])
        head = next((h for h in stacks if key.startswith(h)), None)
        if mode == "fsdp" and head is not None:
            stacks[head].hold_shard(key[len(head):], spec.dim, group)
        elif mode == "fsdp":
            parametrize.register_parametrization(owner, attr, _GatherShard(spec.dim, group),
                                                 unsafe=True)
        else:
            full = getattr(owner, attr)
            setattr(owner, attr, nn.Parameter(rank_slice(full.detach(), spec.dim, group),
                                              requires_grad=full.requires_grad))
    from ..ops.attention import AttentionRoPE
    from ..ops.ffn import ConvFFN, StandardFFN

    if model_size > 1:
        # The ranks of a model group see the same rows and hold each
        # dropout's input whole: they draw one mask (ops.layers.dropout).
        for m in model.modules():
            if isinstance(m, (AttentionRoPE, ConvFFN, StandardFFN)):
                m.dropout_group = group
    if mode == "tensor":
        from ..ops.blocks import ResBlock

        for name, m in model.named_modules():
            if isinstance(m, (AttentionRoPE, ConvFFN, ResBlock)):
                head = f"{prefix}{name + '.' if name else ''}"
                split = {n: isinstance(specs.get(head + n), Shard) for n, _ in
                         m.named_parameters() if n.endswith("weight")}
                probe = {AttentionRoPE: "to_q.weight", ConvFFN: "proj_in.weight",
                         ResBlock: "conv1.weight"}[type(m)]
                if isinstance(m, ConvFFN) and len({split[n] for n in split if n in (
                        "proj_in.weight", "proj_out.weight", "conv.0.weight",
                        "conv.4.weight")}) > 1:
                    raise NotImplementedError(
                        f"{head[:-1]}: the model axis of {model_size} splits this ConvFFN's "
                        "widths in part; no config of the package does (all widths are "
                        "multiples of 128)")
                if split.get(probe):
                    m.model_group = group
    return placement
