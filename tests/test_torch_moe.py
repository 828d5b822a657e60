"""The port's Switch MoE FFN (``deepl_project_tpu_torch/ops/moe.py``)
against the JAX package's ``SwitchFFN`` on the CPU, on the same weights.

- With capacity drops forced (capacity factor 0.5: 2 slots per expert for
  16 tokens): the output, the tokens that fall through (exactly 0), and the
  load-balance loss ``E * sum(f * p_mean)`` against the JAX sown value.
- One expert with room for every token equals the dense FFN body.
- A micro DiT with ``moe_experts=4`` against the JAX DiT.

Tolerances: fp32 1e-5 x max|out| (the router's argmax sees the same fp32
logits up to summation order; a token on a near tie could route to another
expert, which the exact-equality check of the dropped set would show) and
1e-6 relative for the aux loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepl_project_tpu.ops.moe import SwitchFFN as JaxSwitchFFN
from deepl_project_tpu.ops.moe import _FFNBody
from deepl_project_tpu.ops.moe import collect_aux_losses as jax_collect_aux_losses
from deepl_project_tpu_torch.ops.moe import SwitchFFN, collect_aux_losses
from deepl_project_tpu_torch.utils.convert import dit_params_to_torch_state_dict, load_state_dict

from dit_parity import inputs, jax_forward, make_pair, torch_args

torch.set_num_threads(2)
B, N, D, H = 2, 16, 32, 64


def _pair(e: int, cap: float, swiglu: bool = True, seed: int = 0):
    jm = JaxSwitchFFN(d=D, hidden=H, num_experts=e, capacity_factor=cap, use_swiglu=swiglu,
                      expert_axis=None, dtype=jnp.float32, param_dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((B, N, D)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed), x)["params"])
    pm = SwitchFFN(D, H, e, cap, swiglu, None)
    load_state_dict(pm, dit_params_to_torch_state_dict(params))
    return jm, params, pm, x


@pytest.mark.parametrize("swiglu", [True, False])
def test_torch_switch_ffn_matches_jax_with_capacity_drops(swiglu):
    jm, params, pm, x = _pair(4, 0.5, swiglu)
    want, aux_vars = jm.apply({"params": params}, x, mutable=["losses"])
    want = np.asarray(want)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    aux = collect_aux_losses(pm)
    dropped = np.all(want == 0.0, axis=-1)
    # 4 experts x 2 slots per image: at least 8 of each image's 16 tokens drop.
    assert dropped.sum(axis=1).min() >= N - 8
    np.testing.assert_array_equal(np.all(got == 0.0, axis=-1), dropped)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(jax_collect_aux_losses(aux_vars)), rtol=1e-6)
    assert float(aux) >= 0.99  # 1 at perfectly uniform routing
    # Taken off the module: a second collection without a forward is 0.
    assert float(collect_aux_losses(pm)) == 0.0


def test_torch_switch_ffn_one_expert_equals_dense_ffn():
    """E=1 with room for every token: gate 1, nothing dropped, the dense FFN
    body with the expert's weights (as in JAX)."""
    jm, params, pm, x = _pair(1, 4.0)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    body = _FFNBody(d=D, hidden=H, use_swiglu=True, dtype=jnp.float32, param_dtype=jnp.float32)
    dense = np.asarray(body.apply(
        {"params": jax.tree_util.tree_map(lambda a: a[0], params["experts"])}, x))
    assert np.abs(got - dense).max() <= 1e-5 * np.abs(dense).max()
    w = {k: v[0] for k, v in pm.experts.state_dict().items()}
    h = torch.from_numpy(x)
    ref = torch.nn.functional.linear(
        torch.nn.functional.silu(torch.nn.functional.linear(h, w["gate.weight"], w["gate.bias"]))
        * torch.nn.functional.linear(h, w["up.weight"], w["up.bias"]),
        w["down.weight"], w["down.bias"])
    torch.testing.assert_close(torch.from_numpy(got), ref, rtol=1e-5, atol=1e-5)


def test_torch_dit_with_moe_experts_matches_jax():
    jm, params, pm = make_pair(moe_experts=4)
    assert "block0.moe_ffn.experts.gate.weight" in pm.state_dict()
    assert pm.block0.moe_ffn.experts.gate.weight.shape == (4, 170, 64)  # [E, out, in]
    z, t, y = inputs()
    want = np.asarray(jax_forward(jm)(params, z, t, y))
    with torch.no_grad():
        got = pm(*torch_args(z, t, y)).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    assert float(collect_aux_losses(pm)) > 0.0  # both blocks' losses, summed
