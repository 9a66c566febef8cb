"""repro_torch.launch — entry points (serving, training)."""
