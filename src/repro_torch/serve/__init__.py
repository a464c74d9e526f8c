"""Batched serving engine of the port."""
