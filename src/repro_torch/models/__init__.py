"""The model zoo's serving path in PyTorch (all six families)."""
