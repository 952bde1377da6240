"""The reference's side of a federated job: it works out again from the
benchmark's inputs (base weights, initial LoRA, corpus, seed) what the
program derived (the cohorts, the batches, each stage's groups and fused
LoRA) and follows ``check_steps`` local AdamW steps of one client a
round. Which client, and from which step, ``fedbench.data.followed``
draws from the seed: round 0 from its first step, a later round from
any step, so that over runs every step and both clients are followed.

Where the program's own state is needed, it is read from the program's
records: a stage after the first starts from the global LoRA the program
transferred back (checked apart, from the program's trained submodel
LoRA and the reference's groups), a round after the first in a stage
from the program's aggregate, and a window that starts past a round's
first step from the program's LoRA and AdamW state at that step. The
aggregate is checked from the program's own client results.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List

import torch

from fedbench import data as D
from fedbench.reference import devft as R
from fedbench.reference.model import adamw, grads


def stage_plan(model: dict, spec: dict) -> List[tuple]:
    """[(stage, capacity), ...] for each round of one job."""
    n_layers = model["n_layers"]
    if spec["method"] == "devft":
        caps = R.capacity_schedule(n_layers, spec["n_stages"], spec["growth"])
        per = spec["rounds"] // len(caps)
        rounds = [per] * len(caps)
        rounds[-1] += spec["rounds"] - per * len(caps)
        return [(s, c) for s, (c, r) in enumerate(zip(caps, rounds))
                for _ in range(r)]
    return [(0, n_layers)] * spec["rounds"]


def client_lr(spec: dict, stage: int) -> float:
    lr = spec["lr"]
    if spec["method"] != "devft":
        return lr
    f, n = spec["lr_stage_factor"], spec["n_stages"]
    return max(lr * min(f ** (stage - (n - 1)), 1.0), lr * f ** -(n - 1))


def _identity(blocks: dict) -> Dict[str, list]:
    return {n: [[i] for i in range(R._sorted_leaves(s)[0].shape[0])]
            for n, s in blocks.items()}


def follow(reference: ModuleType, model: dict, traffic: dict, params: dict,
           lora0: dict, corpus: dict, seed: int, prog: dict, lower=()) -> dict:
    """The reference's records, through the configuration's reference
    module ``reference`` (``fedbench.reference.module_for``), of the job
    ``prog`` records (see
    ``fedbench.runners.federated.Capture``): per round the groups, the
    fused LoRA, the followed steps' losses, the first one's gradient, the
    LoRA after the steps, and the eval loss of the program's aggregate; per
    stage the global LoRA the transfer gives. ``lower`` makes it a
    lower-precision control, each named precision the configuration
    states one step down: ``weights``, float8 e4m3 frozen weights for
    bf16; ``state``, bf16 LoRA, gradients and AdamW moments for f32."""
    spec = traffic["spec"]
    beta = spec.get("beta", 0.1)
    ref = reference.Model(model, params, beta=beta,
                          quantize="weights" in lower)

    def low(tree):
        """The control's LoRA state in bf16."""
        if "state" not in lower:
            return tree
        if isinstance(tree, dict):
            return {k: low(v) for k, v in tree.items()}
        return tree.to(torch.bfloat16).float()
    n_steps = traffic["check_steps"]
    b, s = spec["local_batch"], spec["seq"]
    plan = stage_plan(model, spec)
    n_sample = max(1, int(spec["n_clients"] * spec["sample_frac"]))
    cohorts = D.cohorts(seed, spec["n_clients"], n_sample, len(plan))
    follows = D.followed(seed, len(plan), n_sample, spec["k_local"], n_steps)
    ev = D.eval_batch(corpus, traffic["eval_batch"], s)
    out = {"rounds": [], "transfers": []}
    groups, prev_groups = None, None
    for r, (stage, cap) in enumerate(plan[:len(prog["rounds"])]):
        p = prog["rounds"][r]
        first_of_stage = r == 0 or plan[r - 1][0] != stage
        if first_of_stage:
            if spec["method"] == "devft":
                entry = prog["entries"][stage]
                glob = lora0 if stage == 0 else entry["global"]
                if stage > 0:
                    out["transfers"].append(
                        (R.broadcast(entry["trained_prev"], prev_groups),
                         entry["global"]))
                groups, gaps = R.stage_groups(params["blocks"], glob, cap,
                                              seed, stage)
                start = R.fuse_lora(glob, groups, beta)
                prev_groups = groups
            else:
                groups, gaps = _identity(params["blocks"]), {}
                start = lora0
        else:
            start = prog["rounds"][r - 1]["agg"]
            gaps = {}
        lr = client_lr(spec, stage)
        client, first = follows[r]
        batches = D.client_steps(corpus, seed, r, cohorts[r][client], first,
                                 n_steps, b, s)
        lora, st = start, None
        if first:
            lora, st = p["start"], p["state"]
            st = {**st, "mu": low(st["mu"]), "nu": low(st["nu"])}
        lora, losses, g1 = low(lora), [], None
        step0 = lora
        for batch in batches:
            loss, g = grads(ref, groups, lora, batch)
            g = low(g)
            losses.append(loss)
            g1 = g if g1 is None else g1
            lora, st = adamw(g, st, lora, lr)
            lora = low(lora)
            st = {**st, "mu": low(st["mu"]), "nu": low(st["nu"])}
        with torch.no_grad():
            _, ev_loss = ref.loss(groups, p["agg"], ev)
        out["rounds"].append({
            "stage": stage, "capacity": cap, "clients": list(cohorts[r]),
            "groups": groups if first_of_stage else None, "gaps": gaps,
            "entry": start if first_of_stage else None, "start": step0,
            "losses": losses, "g1": g1, "after": lora,
            "eval": float(ev_loss)})
    if spec["method"] == "devft" and prog.get("final"):
        out["transfers"].append((R.broadcast(prog["final"]["trained"],
                                             prev_groups),
                                 prog["final"]["global"]))
    return out
