"""The synthetic token stream of the model zoo (counterpart of
``repro.data``)."""
