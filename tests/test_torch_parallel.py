"""The port's parallel placements and row splits against the JAX package's,
on the CPU, with no JAX compile and no process group:

- ``param_specs`` against the JAX ``param_specs`` on the micro model for
  each mode at model sizes 2, 4 and 8, through the converter's key map
  (each JAX leaf encoded by the index along its sharded axis, converted to
  the port's layout, the axis read back): equal for every parameter, also
  where the tensor rule cuts a head (2 heads at C=32 at sizes 4 and 8);
- ``batch_rows`` / ``shard_batch`` against the rows ``batch_sharding``
  places on each device, microbatch by microbatch (the JAX step splits the
  batch into ``accum_steps`` microbatches, then shards each over data);
- ``row_filter`` on the synthetic and folder sources: each data rank's
  stream is its rows of every global batch, and the folder source decodes
  only those files;
- the kernel gates' local width: a tensor-parallel head shard never takes
  the square sublayer kernels.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_jobs as J
from deepl_project_tpu import TransVAE as JaxTransVAE
from deepl_project_tpu import get_config as jax_get_config
from deepl_project_tpu.models.transvae import init_params
from deepl_project_tpu.parallel import batch_sharding
from deepl_project_tpu.parallel import create_mesh as jax_create_mesh
from deepl_project_tpu.parallel import param_specs as jax_param_specs
from deepl_project_tpu_torch.data import batch_iterator, make_dataset, row_filter
from deepl_project_tpu_torch.models import TransVAE
from deepl_project_tpu_torch.ops.attention import AttentionRoPE
from deepl_project_tpu_torch.ops.hopper import fused_attention_block as fab
from deepl_project_tpu_torch.parallel import Shard, batch_rows, param_specs
from deepl_project_tpu_torch.utils.convert import params_to_torch_state_dict
from deepl_project_tpu_torch.utils.image import save_image


@pytest.fixture(scope="module")
def jax_shapes():
    model = JaxTransVAE(jax_get_config(J.VARIANT, **J.MICRO))
    return jax.eval_shape(lambda: init_params(model, jax.random.PRNGKey(0), image_size=J.RES))


def _encode(shape, spec) -> np.ndarray:
    """Zeros, or 1 + the index along the axis ``spec`` shards."""
    axes = [i for i, a in enumerate(tuple(spec)) if a is not None]
    if not axes:
        return np.zeros(shape, np.float32)
    (a,) = axes
    idx = np.arange(shape[a], dtype=np.float32).reshape(
        [-1 if i == a else 1 for i in range(len(shape))])
    return np.broadcast_to(idx + 1, shape).copy()


def _axis(arr: np.ndarray) -> int | None:
    varying = [d for d in range(arr.ndim) if arr.shape[d] > 1
               and not np.all(arr == arr.take([0], axis=d))]
    assert len(varying) <= 1, varying
    return varying[0] if varying else None


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("mode", ["replicate", "fsdp", "tensor"])
def test_param_specs_match_jax(jax_shapes, mode, size):
    specs = jax_param_specs(jax_shapes, mode, size, fsdp_min_size=J.FSDP_MIN)
    encoded = jax.tree_util.tree_map(lambda s, p: _encode(s.shape, p), jax_shapes, specs)
    want = {k: _axis(v) for k, v in params_to_torch_state_dict(encoded).items()}
    with torch.device("meta"):
        model = TransVAE(J.micro_config())
    got = {k: s.dim if isinstance(s, Shard) else None
           for k, s in param_specs(model, mode, size, J.FSDP_MIN).items()}
    assert set(got) == set(want)
    assert {k for k in got if got[k] != want[k]} == set()
    # At size 4 and 8 the tensor rule cuts heads (2 heads at C=32), as JAX's does.
    cut = {f"{n}.to_q.weight" for n, m in model.named_modules()
           if isinstance(m, AttentionRoPE) and (m.dim // m.head_dim) % size}
    assert bool(cut) == (size > 2)
    if mode == "tensor":
        assert all(got[k] is not None for k in cut)
    if mode != "replicate":
        assert any(v is not None for v in got.values())


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("data, model", [(4, 1), (2, 2)])
def test_shard_batch_rows_match_jax_batch_sharding(accum, data, model):
    b = 8
    mesh = jax_create_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    where = {int(d.id): idx for idx, d in np.ndenumerate(mesh.devices)}
    rows = {}
    for i, micro in enumerate(np.arange(b).reshape(accum, b // accum)):
        arr = jax.device_put(micro, batch_sharding(mesh))
        for shard in arr.addressable_shards:
            r, _, m = where[int(shard.device.id)]
            rows.setdefault((r, m), []).extend(int(v) for v in np.asarray(shard.data))
    for (r, m), got in rows.items():
        assert batch_rows(b, r, data, accum).tolist() == got, (r, m)


def test_row_filter_splits_the_synthetic_source():
    b, accum, size = 8, 2, 2
    whole = list(batch_iterator(make_dataset("synthetic", 8, num_samples=24, seed=2), b))
    for r in range(size):
        keep = row_filter(b, accum, r, size)
        mine = list(batch_iterator(make_dataset("synthetic", 8, num_samples=24, seed=2,
                                                keep=keep), b // size))
        assert len(mine) == len(whole)
        for ours, theirs in zip(mine, whole):
            np.testing.assert_array_equal(ours, theirs[batch_rows(b, r, size, accum)])


def test_row_filter_decodes_only_the_ranks_files(tmp_path, monkeypatch):
    from deepl_project_tpu_torch.data import datasets

    rng = np.random.default_rng(0)
    for i in range(12):
        save_image(rng.random((8, 8, 3), np.float32), str(tmp_path / f"{i:02d}.png"))
    decoded = []
    real = datasets._iter_decoded
    monkeypatch.setattr(datasets, "_iter_decoded",
                        lambda files, *a, **kw: decoded.extend(files) or real(files, *a, **kw))
    whole = list(batch_iterator(make_dataset(str(tmp_path), 8, repeat=False), 4))
    n_whole = len(decoded)
    for r in range(2):
        decoded.clear()
        keep = row_filter(4, 1, r, 2)
        mine = list(batch_iterator(make_dataset(str(tmp_path), 8, repeat=False, keep=keep), 2))
        assert len(decoded) == n_whole // 2
        for ours, theirs in zip(mine, whole, strict=True):
            np.testing.assert_array_equal(ours, theirs[batch_rows(4, r, 2)])


def test_kernel_gates_refuse_a_local_head_width():
    # The sublayer kernels take one rank's heads under tensor parallelism:
    # whole heads of 64 within C; other widths and fp32 are refused with
    # their reasons.
    bf = torch.bfloat16
    assert fab.kernel_supported(4096, 384, 64, bf)
    for width in (384, 192, 64):
        assert fab.kernel_supported(4096, 384, 64, bf, width=width)
    assert "width 96" in fab.kernel_refusal(4096, 384, 64, bf, width=96)
    assert "width 768" in fab.kernel_refusal(4096, 384, 64, bf, width=768)
    assert "bf16" in fab.kernel_refusal(4096, 384, 64, torch.float32, width=192)
    assert fab.sublayer_supported(256, 1536, 64, bf)
    assert fab.sublayer_supported(256, 1536, 64, bf, width=768)
    assert fab.sublayer_supported(1024, 768, 64, bf, width=384)
    assert "N=4096" in fab.sublayer_refusal(4096, 384, 64, bf, width=192)
    assert "width 96" in fab.sublayer_refusal(256, 1536, 64, bf, width=96)
    assert fab.proj_supported(384, bf, 192) and not fab.proj_supported(384, bf, 96)
