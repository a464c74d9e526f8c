"""Training of the model zoo: AdamW, int8 gradient compression and the
training step and driver (counterparts of ``repro.train``)."""
