"""Losses and optimisers (port of ``repro.optim``)."""
