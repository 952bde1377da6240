"""C003 — the serving step's contract (the JAX package's
``contracts/serving.py``).

Builds a :class:`~repro_torch.serving.engine.ServingEngine` for each
serving arch family × adapter mode on the given device and runs one
step (``_step``, every slot masked out, as ``warmup`` does):

* arch families: the reduced GQA (qwen2-7b), MLA (deepseek-v3-671b)
  and SSM (mamba2-2.7b) configs at ``BENCH_REDUCED`` widths, 2 layers;
* adapter modes: base weights, one shared adapter, and the multi-tenant
  registry with the per-slot gather.

Checked against :class:`~repro_torch.serving.engine.StepContract`: the
next-token vector is ``int32[n_slots]``, and the new cache
(``engine.kv.cache``) carries exactly the shapes and dtypes of the one
the step was given, leaf by leaf. ``check_step_contract(engine)`` is
the check on one engine, so the card's smoke run can hold its
full-width engines to it.

On ``meta`` (the default) nothing is allocated; on ``cuda`` the step
runs the hand kernels (``flash_decode``, and ``moe_expert_ffn`` on
deepseek's MoE layer).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts.base import (avals_of, contract_finding,
                                                 leaf_mismatches)
from repro_torch.analysis.findings import Finding

PATH = "src/repro_torch/serving/engine.py"
HINT = ("the step must return int32[n_slots] next tokens and leave a "
        "cache with the shapes and dtypes of the one it was given; see "
        "StepContract")

ARCH_FAMILIES = ("qwen2-7b", "deepseek-v3-671b", "mamba2-2.7b")
MODES = ("base", "shared", "multi")
_N_SLOTS, _CAPACITY, _RANK, _N_ADAPTERS = 3, 32, 4, 2


def _family_cfg(arch: str):
    from repro_torch.experiments.presets import BENCH_REDUCED
    from repro_torch.experiments.spec import ExperimentSpec

    return ExperimentSpec(arch=arch, reduced=dict(BENCH_REDUCED),
                          layers=2).build_cfg()


def _model(cfg, device: torch.device, seed: int):
    """f32 params and one rank-``_RANK`` adapter on ``device``."""
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T

    if device.type == "meta":
        return (specs.param_specs(cfg, torch.float32),
                specs.lora_specs(cfg, _RANK))
    gen = torch.Generator(device=device).manual_seed(seed)
    return (T.init_params(cfg, gen, torch.float32),
            T.init_lora(cfg, gen, rank=_RANK))


def make_engine(cfg, mode: str, device="meta", seed: int = 0):
    """A small engine in adapter ``mode`` (``base``, ``shared`` or
    ``multi``) on ``device``."""
    from repro_torch.serving import AdapterRegistry, ServingEngine

    params, lora = _model(cfg, torch.device(device), seed)
    kw = {}
    if mode == "shared":
        kw["lora"] = lora
    elif mode == "multi":
        registry = AdapterRegistry(lora, _N_ADAPTERS)
        for i in range(_N_ADAPTERS):
            registry.add(f"adapter/{i}", lora)
        kw["adapters"] = registry
    elif mode != "base":
        raise ValueError(f"unknown adapter mode {mode!r}; known: "
                         f"{list(MODES)}")
    return ServingEngine(cfg, params, n_slots=_N_SLOTS,
                         kv_capacity=_CAPACITY, **kw)


def check_step_contract(engine) -> List[str]:
    """Run one step of ``engine`` with every slot masked out (the cursors
    stay; the lanes are written, as by ``warmup``) and hold it to its
    class's ``StepContract``. Returns mismatch strings; [] == pass."""
    from repro_torch.serving.engine import StepContract

    contract = getattr(type(engine), "contract", None)
    if not isinstance(contract, StepContract):
        return [f"{type(engine).__name__} declares no StepContract"]
    n = engine.scheduler.n_slots
    before = avals_of(engine.kv.cache)
    nxt = engine._step(engine._adapter_idx.copy(),
                       np.zeros((n, 1), np.int64), np.zeros((n,), bool))
    want = torch.empty((n,), dtype=getattr(torch, contract.next_tokens_dtype),
                       device="meta")
    return (leaf_mismatches(want, nxt, "next_tokens")
            + [f"the new cache drifts from the {contract.donated} it "
               f"replaces ({msg})"
               for msg in leaf_mismatches(before, engine.kv.cache,
                                          contract.donated)])


def check_serving(device="meta", seed: int = 0
                  ) -> Tuple[List[Finding], Dict[str, int]]:
    device = torch.device(device)
    findings: List[Finding] = []
    n_steps = 0
    for arch in ARCH_FAMILIES:
        cfg = _family_cfg(arch)
        for mode in MODES:
            surface = f"serving:{arch}:{mode}:{device.type}"
            try:
                msgs = check_step_contract(make_engine(cfg, mode, device,
                                                       seed))
            except Exception as e:      # a failed step is itself a violation
                findings.append(contract_finding(
                    "C003", PATH, surface,
                    f"step failed: {type(e).__name__}: {e}", HINT))
                continue
            n_steps += 1
            findings += [contract_finding("C003", PATH, surface, msg, HINT)
                         for msg in msgs]

    stats = {"serving_families": len(ARCH_FAMILIES),
             "serving_steps": n_steps}
    return findings, stats
