"""Training the port's encdec and vlm families against the JAX package, in
float32 on the CPU, as tests/test_torch_train_dense.py does (tolerances in
``train_harness``).

Each reference configuration compiles once in this file, so it holds two
tests (ROADMAP.md, test budget)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from train_harness import compare_arch  # noqa: E402


def test_whisper_step_as_the_reference():
    """whisper-large-v3: the encoder over 64 frames (non-causal), the
    decoder's causal self- and cross-attention over 8 tokens; the cross
    biases bk, bv reach no loss, and their gradients are zeros on both
    sides."""
    ran = compare_arch("whisper-large-v3")
    assert not ran["got"]["grads"]["layers/xattn/bk"].any()


def test_qwen2_vl_step_as_the_reference():
    """qwen2-vl-72b: 16 patch embeddings projected over the first
    positions, multimodal RoPE."""
    compare_arch("qwen2-vl-72b")
