"""Simulation models defined outside the engine core (counterpart of
``repro.scenarios``): each module extends the builtin registry
(``BUILTIN.extend()``) with its components, event kinds, handlers and
counters, and the engine, the conflict mask, the owner-wins sync and the
oracle pick them up from the generated ``World`` type.
"""
from repro_torch.scenarios import cache, failures

__all__ = ["cache", "failures"]
