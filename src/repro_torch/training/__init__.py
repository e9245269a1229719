"""Training: the optimizer, the train step, checkpoints and fault
tolerance (PyTorch counterpart of ``repro.training``)."""
