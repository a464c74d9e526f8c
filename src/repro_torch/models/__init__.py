"""The model zoo's serving path in PyTorch (``dense``, ``hybrid``, ``ssm``)."""
