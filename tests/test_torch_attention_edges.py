"""Three edge cases of the port's plain attention, through the check of
``tests/test_torch_attention.py``: the card's bfloat16 edge (a window that
is no multiple of any tile, lengths off the kernels' blocks, group 5) and
causal attention with Sq != Skv (the mask has no offset): fewer queries
than keys with a window, and more queries than keys with a window, so rows
63 and on have no key in their band and take the mean of every value.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_attention import check_attention  # noqa: E402


@pytest.mark.parametrize("bh,bkv,sq,skv,d,causal,window,dtype,block", [
    (10, 2, 200, 200, 64, True, 100, "bfloat16", 40),
    (6, 2, 48, 112, 32, True, 24, "float32", 16),
    (4, 2, 96, 48, 16, True, 16, "float32", 16),
])
def test_plain_attention_matches_pallas_and_ref(bh, bkv, sq, skv, d, causal,
                                                window, dtype, block):
    check_attention(bh, bkv, sq, skv, d, causal, window, dtype, block)
