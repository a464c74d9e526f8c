"""PyTorch/CUDA port of the conservative-window DES engine (``repro``) and
of its model zoo's serve path.

The JAX package ``repro`` stays the reference; this package keeps its module
and function names so every counterpart is easy to find. The JAX vmap agent
axis is an explicit leading tensor dimension ``A``, collectives are
reductions and transposes over it, and the window loop is stepped from the
host. The model zoo (``configs/``, ``models/``, ``serve/``,
``launch/serve.py``) serves the dense, hybrid and ssm families. Every
Pallas kernel of the reference is a hand-written CUDA kernel for Hopper
(``kernels/csrc/``: the six window front-end kernels in
``event_select.cu``, the max-min water-fill in ``bandwidth_share.cu``,
attention in ``flash_attention.cu``, the RWKV6 and SSD scans in
``rwkv6_scan.cu``); a CPU tensor takes their plain PyTorch versions
(``kernels/ref.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device  # noqa: F401
