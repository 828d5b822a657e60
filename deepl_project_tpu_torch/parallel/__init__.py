"""Data-, FSDP-, tensor- and context-parallel training over
``torch.distributed`` (PyTorch port of ``deepl_project_tpu/parallel``): the
mesh, torchrun's process group, the collectives as autograd functions, the
parameter placements, and ring context parallelism (the ambient context
group, the halo exchange and the ring; ``shard_rows`` is the JAX package's
``context_batch_sharding``), and the latent DiT's GPipe pipeline and
expert parallelism over a (data, pipe, expert) mesh (``create_dit_mesh``,
``use_axes``, ``pipeline_apply``, ``PipelinePlacement``)."""

from .collectives import (all_reduce_mean_, copy_to_group, gather_from_group, global_mean,
                          reduce_from_group, reduce_scatter, reduce_metrics,
                          scatter_to_group, send_recv, sum_over_group)
from .context import context_axis_size, context_parallel, shard_rows
from .halo import context_conv2d, exchange_rows
from .mesh import (CONTEXT_AXIS, DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, Replicate,
                   Shard, ambient, batch_rows, create_dit_mesh, create_mesh, data_axis_size,
                   replicated, serving_rows, shard_batch, use_axes)
from .multihost import host_shard_info, initialize_multihost, under_torchrun
from .pipeline import PipelinePlacement, pipeline_apply, stage_range
from .ring_attention import (context_parallel_attention, ring_attention,
                             ring_attention_reference, ring_shift,
                             sequence_parallel_attention)
from .sharding import Placement, canonical_name, param_specs, shard_params

__all__ = [
    "CONTEXT_AXIS", "DATA_AXIS", "MODEL_AXIS", "create_mesh", "replicated", "shard_batch",
    "batch_rows", "data_axis_size", "Replicate", "Shard", "param_specs", "shard_params",
    "Placement", "canonical_name", "initialize_multihost", "host_shard_info",
    "under_torchrun", "all_reduce_mean_", "reduce_metrics", "copy_to_group",
    "reduce_from_group", "gather_from_group", "scatter_to_group", "reduce_scatter",
    "global_mean", "sum_over_group", "send_recv", "context_parallel", "context_axis_size",
    "shard_rows", "exchange_rows", "context_conv2d",
    "ring_attention", "ring_attention_reference", "ring_shift", "context_parallel_attention",
    "sequence_parallel_attention", "PIPE_AXIS", "EXPERT_AXIS", "create_dit_mesh", "use_axes",
    "ambient", "pipeline_apply", "stage_range", "PipelinePlacement", "serving_rows",
]

