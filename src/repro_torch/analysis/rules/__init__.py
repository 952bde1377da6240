"""Built-in rules — importing this package registers R001, R002, R006
and R010 (the JAX package's IDs; its other rules have no torch
meaning)."""
from repro_torch.analysis.rules import (  # noqa: F401
    r001_seed_streams,
    r002_mask_constants,
    r006_autograd_function,
    r010_contract_coverage,
)
