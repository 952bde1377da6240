from repro_torch.checkpoint.checkpoint import restore, save  # noqa: F401
