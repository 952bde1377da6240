"""Kernel registry: named ops mapped to per-backend implementations,
resolved by the device of the tensors they run on.

Backends (the same three names as the JAX package):

* ``pallas`` — the hand-written Hopper kernels (``csrc/``). The name is
  kept so configs and specs written by the JAX package load unchanged.
* ``reference`` — the plain PyTorch version of each kernel.
* ``auto`` — the default: the same as ``pallas``.

Resolution follows the **device**, never the host platform:

* a CPU tensor gets the plain version, whatever the backend;
* a CUDA tensor with ``reference`` gets the plain version (asked for
  explicitly — the chip smoke run compares kernels against it);
* a CUDA tensor with ``auto``/``pallas`` gets the Hopper kernel, and
  resolution **raises** if the name has none or the card is not compute
  capability (9, 0). There is no silent fallback to the plain version
  on the card.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List

import torch


class KernelBackend(str, enum.Enum):
    PALLAS = "pallas"
    REFERENCE = "reference"
    AUTO = "auto"


BACKENDS = tuple(b.value for b in KernelBackend)

#: compute capability the Hopper kernels are built for (sm_90a)
HOPPER = (9, 0)


def canonical(backend) -> str:
    """Normalize a ``KernelBackend`` | str to its string value."""
    value = backend.value if isinstance(backend, KernelBackend) else backend
    if value not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"known: {list(BACKENDS)}")
    return value


def resolve(backend, device) -> str:
    """The concrete backend (``pallas`` | ``reference``) that runs on
    ``device``. Raises for a CUDA device that is not Hopper when a
    kernel is asked for."""
    value = canonical(backend)
    device = torch.device(device)
    if device.type != "cuda" or value == KernelBackend.REFERENCE.value:
        return KernelBackend.REFERENCE.value
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != HOPPER:
        raise RuntimeError(
            f"the Hopper kernels need compute capability {HOPPER}, but "
            f"{device} has {tuple(cap)}; pass kernel_backend='reference' "
            f"to run the plain PyTorch versions on this card")
    return KernelBackend.PALLAS.value


def use_kernel(backend, device) -> bool:
    """Whether a model op on ``device`` takes its kernel branch (the
    Hopper kernel) under ``backend``: the predicate the layers' branches
    test, as the JAX package's ``use_pallas``. Raises as ``resolve``."""
    return resolve(backend, device) == KernelBackend.PALLAS.value


_KERNELS: Dict[str, Dict[str, Callable]] = {}
_builtins_loaded = False


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declared output contract of one kernel name, shared by every
    implementation registered under it. ``family`` names the shape
    family the JAX package's contract checker uses; ``out`` is
    ``"like:<arg>"``, ``"x@w"`` or ``"q^v"`` (``q``'s shape with ``v``'s
    trailing dim)."""
    family: str
    out: str


_CONTRACTS: Dict[str, KernelContract] = {}


def declare_kernel_contract(name: str, *, family: str, out: str) -> None:
    """Declare the contract every implementation of ``name`` satisfies
    (one declaration per name, beside its ``register_kernel`` calls)."""
    _CONTRACTS[name] = KernelContract(family=family, out=out)


def kernel_contracts() -> Dict[str, KernelContract]:
    _ensure_builtin_kernels()
    return dict(_CONTRACTS)


def register_kernel(name: str, backend, fn: Callable) -> Callable:
    """Register ``fn`` as the ``backend`` implementation of ``name``
    (``pallas`` or ``reference``, not ``auto``)."""
    _ensure_builtin_kernels()
    value = canonical(backend)
    if value == KernelBackend.AUTO.value:
        raise ValueError("register under a concrete backend, not 'auto'")
    impls = _KERNELS.setdefault(name, {})
    if value in impls:
        raise ValueError(f"kernel {name!r} already has a {value!r} "
                         f"implementation")
    impls[value] = fn
    return fn


def get_kernel(name: str, backend="auto", device="cpu") -> Callable:
    """The implementation of ``name`` that runs on ``device`` under
    ``backend`` (see the module docstring for the rule)."""
    _ensure_builtin_kernels()
    try:
        impls = _KERNELS[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; "
                       f"known: {available_kernels()}") from None
    value = resolve(backend, device)
    fn = impls.get(value)
    if fn is None:
        raise KeyError(f"kernel {name!r} has no {value!r} implementation "
                       f"for {torch.device(device)}")
    return fn


def available_kernels() -> Dict[str, List[str]]:
    _ensure_builtin_kernels()
    return {name: sorted(impls) for name, impls in sorted(_KERNELS.items())}


def _ensure_builtin_kernels() -> None:
    """Populate the registry with the in-repo kernels on first use
    (lazy, so this module stays import-cycle-free)."""
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.kernels.flash_decode import flash_decode_bhrd
    from repro_torch.kernels.lora_matmul import lora_matmul_fused
    from repro_torch.kernels.moe_ffn import moe_expert_ffn_ecd
    from repro_torch.kernels.ssd_scan import ssd_scan_bshp

    # whole-sequence causal / windowed attention (training and prefill)
    register_kernel("flash_attention", "pallas", flash_attention_bshd)
    register_kernel("flash_attention", "reference", ref.attention_bshd_ref)
    declare_kernel_contract("flash_attention", family="attention",
                            out="like:q")
    # frozen-weight matmul with the LoRA bypass fused in (W_q, W_v)
    register_kernel("lora_matmul", "pallas", lora_matmul_fused)
    register_kernel("lora_matmul", "reference", ref.lora_matmul_ref)
    declare_kernel_contract("lora_matmul", family="lora", out="x@w")
    # batched expert SwiGLU over (E, C, d) capacity buffers (MoE blocks)
    register_kernel("moe_expert_ffn", "pallas", moe_expert_ffn_ecd)
    register_kernel("moe_expert_ffn", "reference", ref.moe_expert_ffn_ref)
    declare_kernel_contract("moe_expert_ffn", family="moe_ffn",
                            out="like:buf")
    # Mamba-2 chunked SSD forward; the reference is the chunked plain
    # version, not the O(S) sequential oracle: it is what the model's
    # plain branch runs and what the kernel's backward differentiates
    register_kernel("ssd_scan", "pallas", ssd_scan_bshp)
    register_kernel("ssd_scan", "reference", ref.ssd_scan_bshp_chunked_ref)
    declare_kernel_contract("ssd_scan", family="ssd", out="like:x")

    # single-token ragged-cache decode attention (the serving step's
    # kernel); out="q^v": absorbed-MLA decode attends latents whose v
    # head dim differs from the qk head dim
    register_kernel("flash_decode", "pallas", flash_decode_bhrd)
    register_kernel("flash_decode", "reference", ref.flash_decode_ref)
    declare_kernel_contract("flash_decode", family="decode", out="q^v")
