"""Hopper kernels of the window front end and their plain PyTorch versions.

``ref`` holds the plain versions, ``event_select`` the CUDA wrappers (built
from ``csrc/`` by ``build``), and ``ops`` sends a CPU tensor to the former and
a CUDA tensor to the latter.
"""
