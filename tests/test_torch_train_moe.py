"""Training the port's moe family against the JAX package, in float32 on
the CPU, as tests/test_torch_train_dense.py does (tolerances in
``train_harness``): the load-balancing aux loss carried out of every moe
layer and summed into the loss at AUX_WEIGHT, its gradient through the
router, and moonshot's leading dense layer summed after the rest.

Each reference configuration compiles once in this file, so it holds two
tests (ROADMAP.md, test budget)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from train_harness import compare_arch  # noqa: E402


def test_mixtral_step_as_the_reference():
    """mixtral-8x22b: 4 experts, top 2, window 32; aux > 0."""
    assert compare_arch("mixtral-8x22b")["got"]["aux"] > 0


def test_moonshot_step_as_the_reference():
    """moonshot-v1-16b-a3b: a leading dense layer, then a moe layer."""
    assert compare_arch("moonshot-v1-16b-a3b")["got"]["aux"] > 0
