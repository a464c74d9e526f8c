"""Three cases of the port's plain ``fused_select`` against the reference's
``fused_select_ref`` and ``fused_select_xla``, through the check of
``tests/test_torch_kernels.py``: a single-lane window, all slots safe with
the ring cursor wrapping, and no safe slot. Each compiles the reference
for its shape, so the cases sit in a file of at most 3 tests.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_kernels import check_fused_xla  # noqa: E402


@pytest.mark.parametrize("cap,xcap,density,tail,seed", [
    (128, 1, 0.4, 0, 3),       # single-lane window
    (512, 64, 1.0, 500, 4),    # all slots safe, ring cursor wraps
    (128, 32, 0.0, 5, 5),      # no safe slot
])
def test_fused_select_matches_ref_and_xla(cap, xcap, density, tail, seed):
    check_fused_xla(cap, xcap, density, tail, seed)
