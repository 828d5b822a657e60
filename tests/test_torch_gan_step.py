"""The port's GAN step against the JAX package's ``make_gan_train_step`` on
the CPU, the generator's side: the adaptive weight off and on, the warmup
gate and ramp, a frozen encoder (the harness and its tolerances:
tests/gan_step_parity.py; the discriminator's side, R1 and the floor:
tests/test_torch_gan_disc_step.py; the two files run on separate workers,
each JAX step case costing ~10-15 s to trace and compile).
"""

import pytest
from gan_step_parity import make_shared, run_case


@pytest.fixture(scope="module")
def shared():
    return make_shared()


@pytest.mark.parametrize("case", ["adaptive_off", "adaptive_on", "gate", "freeze_encoder"])
def test_gan_step_matches_jax(case, shared):
    run_case(case, shared)
