"""Hand-written Hopper kernels, their plain PyTorch versions and the
registry that picks between them by device. Importing this package
builds nothing: each kernel is compiled at its first CUDA call."""
from repro_torch.kernels.common import NEG_INF  # noqa: F401
from repro_torch.kernels.dispatch import (  # noqa: F401
    BACKENDS,
    KernelBackend,
    available_kernels,
    get_kernel,
    register_kernel,
    resolve,
    use_kernel,
)
from repro_torch.kernels.ops import (  # noqa: F401
    flash_attention,
    flash_decode,
    lora_matmul,
    moe_expert_ffn,
)
