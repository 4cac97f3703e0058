"""Optimizers written out over dicts of tensors (no ``torch.optim``)."""
