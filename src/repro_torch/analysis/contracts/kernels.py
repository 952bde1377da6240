"""C001 — kernel registry contracts (the JAX package's
``contracts/kernels.py``).

Every kernel name in ``repro_torch.kernels.dispatch`` must declare a
:class:`~repro_torch.kernels.dispatch.KernelContract`; every registered
backend, plus ``auto``, is then called over its declared shape family
and the output's shape and dtype checked against the contract.

Resolution follows the tensors' device (``dispatch.resolve``), so the
same checker holds different implementations on different devices:

* ``meta`` (the default; nothing allocated): every backend resolves to
  the plain version; then, inside ``dispatch.meta_kernels``, ``pallas``
  and ``auto`` resolve to the one-card dry-run's shape-only stand-ins of
  the hand kernels (``launch.dryrun._stand_ins``), on whose outputs the
  dry-run's memory counts rest (device label ``meta-stand-in``);
* ``cuda``: ``pallas`` and ``auto`` are the hand kernels, called on
  real tensors of the family's shapes, ``reference`` the plain version
  on the card — the one place the hand kernels themselves are held to
  their declared contracts;
* ``cpu``: every backend is the plain version.

Surface keys carry the device: ``kernel:{name}:{backend}:{device}:{tag}``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from repro_torch.analysis.contracts import shapes
from repro_torch.analysis.contracts.base import (aval_str, contract_finding,
                                                 leaf_mismatches)
from repro_torch.analysis.findings import Finding

PATH = "src/repro_torch/kernels/dispatch.py"
HINT = ("declare the expected output with declare_kernel_contract() next "
        "to the register_kernel() calls, or fix the implementation so "
        "every backend agrees with the declared contract")


def _expected(out_spec: str, args: Dict) -> torch.Tensor:
    """Resolve a contract's ``out`` spec against the case operands (a
    meta tensor of the expected shape and dtype)."""
    def like(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if out_spec.startswith("like:"):
        x = args[out_spec[5:]]
        return like(x.shape, x.dtype)
    if out_spec == "x@w":
        x, w = args["x"], args["w"]
        return like((*x.shape[:-1], w.shape[-1]), x.dtype)
    if out_spec == "q^v":
        # attention whose value head dim differs from qk's (absorbed-MLA
        # decode attends latents): q's shape with v's trailing dim, in
        # v's dtype. The port follows the JAX package's reference
        # (ref.flash_decode_ref returns v's dtype); JAX's checker expects
        # q's, which its Pallas kernel returns. The two differ only for
        # f32 q against a bf16 cache; the families hold q and v in f32.
        q, v = args["q"], args["v"]
        return like((*q.shape[:-1], v.shape[-1]), v.dtype)
    raise ValueError(f"unknown contract out spec {out_spec!r}")


def _passes(device: torch.device, backends: List[str]):
    """-> [(device label, context, backends)] to check on ``device``."""
    everything = (*backends, "auto")
    if device.type != "meta":
        return [(device.type, contextlib.nullcontext, everything)]
    from repro_torch.kernels import dispatch
    from repro_torch.launch.dryrun import _stand_ins, _Tally

    return [("meta", contextlib.nullcontext, everything),
            ("meta-stand-in",
             lambda: dispatch.meta_kernels(_stand_ins(_Tally())),
             ("pallas", "auto"))]


def check_kernels(device="meta", seed: int = 0
                  ) -> Tuple[List[Finding], Dict[str, int]]:
    from repro_torch.kernels import dispatch

    device = torch.device(device)
    registry = dispatch.available_kernels()
    contracts = dispatch.kernel_contracts()
    findings: List[Finding] = []
    n_surfaces = n_calls = 0

    for name, backends in registry.items():
        contract = contracts.get(name)
        if contract is None:
            findings.append(contract_finding(
                "C001", PATH, f"kernel:{name}",
                f"registered kernel {name!r} declares no KernelContract",
                HINT))
            continue
        cases = list(shapes.kernel_cases(contract.family, device, seed))
        for label, context, names in _passes(device, backends):
            n_surfaces += len(names)
            with context():
                for backend in names:
                    fn = dispatch.get_kernel(name, backend, device)
                    for tag, args, kwargs in cases:
                        surface = f"kernel:{name}:{backend}:{label}:{tag}"
                        try:
                            with torch.no_grad():
                                out = fn(*args.values(), **kwargs)
                        except Exception as e:  # a failed call is itself a violation
                            findings.append(contract_finding(
                                "C001", PATH, surface,
                                f"call failed: {type(e).__name__}: {e}",
                                HINT))
                            continue
                        n_calls += 1
                        expected = _expected(contract.out, args)
                        for msg in leaf_mismatches(expected, out):
                            findings.append(contract_finding(
                                "C001", PATH, surface,
                                f"output violates contract "
                                f"out={contract.out!r}: {msg} "
                                f"(expected {aval_str(expected)})", HINT))

    stats = {"kernels": len(registry), "kernel_surfaces": n_surfaces,
             "kernel_calls": n_calls}
    return findings, stats
