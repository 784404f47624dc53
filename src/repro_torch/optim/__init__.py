"""The optimizer of the training path (``repro/optim``)."""
