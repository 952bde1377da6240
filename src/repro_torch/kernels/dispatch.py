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

Tuning (``repro_torch.kernels.autotune`` fills the cache): only when a
tuning cache was installed on purpose (``set_tuning_cache``, or the file
``$REPRO_TORCH_TUNING_CACHE`` names), ``get_kernel`` returns a tunable
Hopper kernel for a CUDA tensor on ``auto``/``pallas`` behind a thin
wrapper that looks the call's shapes up under the card's name and passes
the tuned knobs to the kernel's ``plan`` (explicit keyword arguments
win). A cached entry that the plan refuses raises; it is not dropped for
the plan's own choice. With no cache installed, and for every CPU
tensor, the kernel is returned as it is and no cache is read.

Meta tensors (the one-card dry-run): within ``meta_kernels(stand_ins)``,
a ``meta`` tensor on ``auto``/``pallas`` takes the kernel branch and
resolves to the given shape-only stand-in; outside it, to the plain
version, as any tensor that is not on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools
import os
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels import tuning


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
    if value == KernelBackend.REFERENCE.value:
        return value
    if device.type == "meta" and _META_KERNELS:
        return KernelBackend.PALLAS.value
    if device.type != "cuda":
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
#: shape-only stand-ins that meta tensors resolve to (``meta_kernels``)
_META_KERNELS: Dict[str, Callable] = {}


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


def get_kernel(name: str, backend="auto", device="cpu", *,
               tuned: bool = True) -> Callable:
    """The implementation of ``name`` that runs on ``device`` under
    ``backend`` (see the module docstring for the rule); a tunable
    Hopper kernel behind its tuning-cache lookup when a cache is
    installed, unless ``tuned=False``."""
    _ensure_builtin_kernels()
    try:
        impls = _KERNELS[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; "
                       f"known: {available_kernels()}") from None
    value = resolve(backend, device)
    if value == KernelBackend.PALLAS.value \
            and torch.device(device).type == "meta":
        return _META_KERNELS[name]
    fn = impls.get(value)
    if fn is None:
        raise KeyError(f"kernel {name!r} has no {value!r} implementation "
                       f"for {torch.device(device)}")
    if tuned and value == KernelBackend.PALLAS.value \
            and name in tuning.KERNELS and tuning_cache() is not None:
        return _tuned_wrapper(name, fn)
    return fn


@contextlib.contextmanager
def meta_kernels(stand_ins: Dict[str, Callable]):
    """Within the block, ``meta`` tensors on ``auto``/``pallas`` take the
    kernel branches and resolve to ``stand_ins`` (name -> a function
    that makes the kernel's output from the shapes): the one-card
    dry-run's view of the card's path."""
    if _META_KERNELS:
        raise RuntimeError("meta_kernels is already active")
    _META_KERNELS.update(stand_ins)
    try:
        yield
    finally:
        _META_KERNELS.clear()


# ---------------------------------------------------------------------------
# Tuning-cache consultation (the read side; the autotuner fills it)
# ---------------------------------------------------------------------------

_TUNING: Dict[str, Optional[tuning.TuningCache]] = {"cache": None}
#: the caches read from $REPRO_TORCH_TUNING_CACHE, by path (read once)
_ENV_CACHES: Dict[str, tuning.TuningCache] = {}
_TUNED_WRAPPERS: Dict[tuple, Callable] = {}


def set_tuning_cache(cache: Optional[tuning.TuningCache]
                     ) -> Optional[tuning.TuningCache]:
    """Install ``cache`` for every later tuned resolution (None to
    uninstall); returns the one installed before."""
    previous, _TUNING["cache"] = _TUNING["cache"], cache
    return previous


def tuning_cache() -> Optional[tuning.TuningCache]:
    """The cache installed on purpose: ``set_tuning_cache``'s, else the
    file ``$REPRO_TORCH_TUNING_CACHE`` names (read once), else None."""
    if _TUNING["cache"] is not None:
        return _TUNING["cache"]
    path = os.environ.get(tuning.CACHE_ENV)
    if not path:
        return None
    if path not in _ENV_CACHES:
        _ENV_CACHES[path] = tuning.TuningCache.load(path)
    return _ENV_CACHES[path]


@functools.lru_cache(maxsize=None)
def _source_hash(name: str) -> str:
    return tuning.source_hash(name)


@functools.lru_cache(maxsize=16)
def device_name(device: torch.device) -> str:
    """The name of a CUDA device (cached per device)."""
    return torch.cuda.get_device_name(device)


def tuned_config(name: str, args=(), kwargs: Optional[dict] = None, *,
                 device: Optional[str] = None,
                 key: Optional[str] = None) -> Optional[Dict]:
    """The tuned knobs for one call of kernel ``name`` (its positional
    operands ``args`` and keyword arguments, or a precomputed ``key``) on
    the card named ``device`` (default: the first operand's), or None
    with no cache installed, on a miss or on a stale entry (the plan's
    own knobs then)."""
    cache = tuning_cache()
    if cache is None:
        return None
    if device is None:
        device = device_name(args[0].device)
    if not cache.has_device(device):
        return None
    if key is None:
        key = tuning.shape_key(name, args, kwargs)
    return cache.lookup(device, name, key, _source_hash(name))


def _tuned_wrapper(name: str, fn: Callable) -> Callable:
    """``fn`` with the tuned knobs for the call's shapes merged under the
    caller's keyword arguments (explicit ones win); memoized."""
    wrapper = _TUNED_WRAPPERS.get((name, fn))
    if wrapper is None:
        @functools.wraps(fn, updated=())     # the counts stay on fn
        def wrapper(*args, **kwargs):
            knobs = tuned_config(name, args, kwargs)
            if knobs:
                kwargs = {**knobs, **kwargs}
            return fn(*args, **kwargs)

        _TUNED_WRAPPERS[(name, fn)] = wrapper
    return wrapper


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
