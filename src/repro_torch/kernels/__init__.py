"""Hopper kernels of the port and their plain PyTorch versions.

``ref`` holds the plain versions; ``event_select`` (the window front end) and
``bandwidth_share`` (the max-min water-fill) the CUDA wrappers, built from
``csrc/`` by ``build``; ``ops`` sends a CPU tensor to the former and a CUDA
tensor to the latter.
"""
