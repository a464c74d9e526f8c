"""Fault tolerance of the training fleet: straggler detection and elastic
re-meshing (counterparts of ``repro.ft``)."""
