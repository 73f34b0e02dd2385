"""One train step of the port against ``make_train_step``, as
``test_torch_train_step.py`` (whose docstring states the tolerances), for a
relativistic mode with the path-length penalty on and for a decaying
learning rate over two steps (a separate file, so that the test workers
share the JAX compiles)."""

import pytest

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import (check_step_adam, check_step_discriminator, check_step_generators,
                          check_step_scalars, run_step_case)


@pytest.fixture(scope="module", params=["dusty2_ragan_pl", "plain_decay"])
def case(request):
    return run_step_case(request.param)


def test_scalars_match_jax(case):
    check_step_scalars(case)


def test_generators_match_jax(case):
    check_step_generators(case)


def test_discriminator_matches_jax(case):
    check_step_discriminator(case)


def test_adam_states_match_jax(case):
    check_step_adam(case)
