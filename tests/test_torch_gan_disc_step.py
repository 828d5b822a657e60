"""The port's GAN step against the JAX package's ``make_gan_train_step`` on
the CPU, the discriminator's side: R1 (a double backward through D) and the
disc loss floor, whose zeroed gradients still move D through Adam's
moments (the harness and its tolerances: tests/gan_step_parity.py).
"""

import pytest
from gan_step_parity import make_shared, run_case


@pytest.fixture(scope="module")
def shared():
    return make_shared()


@pytest.mark.parametrize("case", ["r1", "floor"])
def test_gan_step_matches_jax(case, shared):
    run_case(case, shared)
