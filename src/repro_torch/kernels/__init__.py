"""Hopper kernels of the port and their plain PyTorch versions.

``ref`` holds the plain versions; ``event_select`` (the window front end),
``bandwidth_share`` (the max-min water-fill), ``flash_attention`` (the model
zoo's prefill attention) and ``rwkv6_scan``/``ssm_scan`` (the chunked
gated linear attention of RWKV6 and of the SSD heads) the CUDA wrappers,
built from ``csrc/`` by ``build``; ``ops`` sends a CPU tensor to the former
and a CUDA tensor to the latter.
"""
