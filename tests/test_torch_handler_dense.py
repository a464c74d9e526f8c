"""The whole-table merge of ``merge_mode="dense"`` against the reference's
``apply_handler_batch_dense``, byte for byte, on the batched dispatch of
``tests/test_torch_core.py`` (its helpers). The reference's dispatch
compiles for seconds, so this sits in a file of at most 3 tests (see
test_torch_engine.py).
"""
import functools

import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import components as jcomp  # noqa: E402
from repro.core import handlers as jhand  # noqa: E402
from repro_torch.core import components as tcomp  # noqa: E402
from repro_torch.core import handlers as thand  # noqa: E402

from test_torch_core import _check_batch  # noqa: E402

_RUN_J_DENSE = jax.jit(functools.partial(jhand.apply_handler_batch_dense,
                                         jcomp.BUILTIN.make_handlers(2, 2.0)))


@pytest.mark.parametrize("kind", [tcomp.K_FLOW_START, "mixed", "nan"])
def test_apply_handler_batch_dense_matches_reference(kind):
    """The whole-table merge of ``merge_mode="dense"``. In "nan" (flow
    starts on a world with NaN rates) the reference's ``!=`` takes the first
    active lane's copy of a NaN element, so a later lane's new rate is lost:
    the one case where the dense merge differs from the delta merge."""
    _check_batch(kind, _RUN_J_DENSE, thand.apply_handler_batch_dense)
