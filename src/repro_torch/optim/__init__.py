from repro_torch.optim.adamw import AdamWState, adamw_update, init_adamw  # noqa: F401
from repro_torch.optim.schedule import cosine, staged_cosine, staged_lr, wsd  # noqa: F401
