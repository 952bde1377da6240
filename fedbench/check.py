"""The comparison that decides ``correct``: the program's records of a job
against the reference's, as numbers, each held to a limit of the cell.

* ``loss``: the largest relative gap of a followed step's loss.
* ``grad``: the worst leaf's gap between the norms of the first followed
  step's gradient (the program's worked out from its AdamW state before
  and after that step, ``(mu' - B1 mu) / (1 - B1)``), against the larger
  of the reference's norm of that leaf and of the median leaf. A leaf is
  one layer of one LoRA factor.
* ``grad_err``: the same leaves and denominators, with the norm of the
  two gradients' difference in place of the gap of their norms: it reads
  a change of direction, such as a lower precision's rounding, which
  leaves the norms alike.
* ``update``: the gap of norms of the LoRA's change over the followed
  steps, over the leaves whose first gradient in the reference is at
  least a thousandth of the median leaf's (the others move under Adam by
  round-off alone).
* ``grad_err_median``: the median over leaves of the same ratio as
  ``grad_err``; ``grad_err_tree``: the norm of the two gradients'
  difference over the norm of the reference's, over all leaves at once.
* ``eval``: the largest relative gap of a round's eval loss (the
  program's aggregate, evaluated by the reference).
* ``agg``: the largest relative gap of the program's aggregate from the
  mean of its two clients' results (FedAvg).
* ``entry``: the largest relative gap of a stage's fused LoRA.
* ``cohort``, ``groups``, ``transfer``: exact; the rounds whose sampled
  clients differ, the stacks whose groups differ, and the LoRA elements
  of the transfer back that differ.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import torch

#: the numbers, in the order they are printed
NAMES = ("loss", "grad", "grad_err", "grad_err_median", "grad_err_tree",
         "update", "eval", "agg", "entry", "cohort", "groups", "transfer")
#: AdamW's first-moment decay, the program's and the reference's
B1 = 0.9
#: leaves whose first gradient is under this share of the median leaf's
#: are left out of ``update``
MOVED = 1e-3


def _slices(tree, path=()):
    """{(path..., layer): tensor} of every per-layer slice of a LoRA tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_slices(tree[k], path + (k,)))
        return out
    return {path + (i,): tree[i] for i in range(tree.shape[0])}


def _norms(tree) -> Dict[tuple, float]:
    sl = _slices(tree)
    keys = list(sl)
    if not keys:
        return {}
    vals = torch.stack([sl[k].double().norm() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return 0.0 if n == 0 else (xs[n // 2] if n % 2 else
                               0.5 * (xs[n // 2 - 1] + xs[n // 2]))


def _sub(a, b):
    if isinstance(a, dict):
        return {k: _sub(a[k], b[k]) for k in a}
    return a.double() - b.double()


def leaf_gap(got: Dict[tuple, float], ref: Dict[tuple, float], keep=None
             ) -> float:
    """max over leaves of |got - ref| / max(ref, median ref)."""
    return leaf_ratio({k: abs(got[k] - r) for k, r in ref.items()}, ref, keep)


def leaf_ratio(num: Dict[tuple, float], ref: Dict[tuple, float], keep=None,
               over=max) -> float:
    """``over`` (max by default) across leaves of num / max(ref, median
    ref)."""
    med = _median(list(ref.values()))
    vals = [num[k] / max(r, med) for k, r in ref.items()
            if (keep is None or k in keep) and max(r, med) > 0]
    return over(vals) if vals else 0.0


def _rel_tree(a, b) -> float:
    num = sum(float((x.double() - y.double()).norm() ** 2)
              for x, y in zip(_leaves(a), _leaves(b)))
    den = sum(float(y.double().norm() ** 2) for y in _leaves(b))
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _mean_of(trees):
    if isinstance(trees[0], dict):
        return {k: _mean_of([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.double() for t in trees]).mean(0)


def step_numbers(got_round: dict, ref_round: dict) -> Dict[str, float]:
    """loss, grad, grad_err(_median, _tree) and update of one round's
    followed steps."""
    loss = max(abs(g - r) / abs(r) for g, r in zip(got_round["losses"],
                                                    ref_round["losses"]))
    g_ref = _norms(ref_round["g1"])
    grad = leaf_gap(_norms(got_round["g1"]), g_ref)
    diff = _sub(got_round["g1"], ref_round["g1"])
    d_norms = _norms(diff)
    grad_err = leaf_ratio(d_norms, g_ref)
    grad_err_median = leaf_ratio(d_norms, g_ref, over=_median)
    grad_err_tree = math.sqrt(sum(v * v for v in d_norms.values())
                              / max(sum(v * v for v in g_ref.values()),
                                    1e-300))
    med = _median(list(g_ref.values()))
    keep = {k for k, v in g_ref.items() if v >= MOVED * med}
    upd = leaf_gap(_norms(_sub(got_round["after"], got_round["start"])),
                   _norms(_sub(ref_round["after"], ref_round["start"])), keep)
    return {"loss": loss, "grad": grad, "grad_err": grad_err,
            "grad_err_median": grad_err_median,
            "grad_err_tree": grad_err_tree, "update": upd}


def numbers(got: dict, ref: dict) -> Dict[str, float]:
    """Every number the records ``got`` (the program's, or a control's)
    hold against the reference's records ``ref``."""
    out = {n: 0.0 for n in NAMES}
    n_cohort = n_groups = n_transfer = 0
    have = set()
    for g, r in zip(got["rounds"], ref["rounds"]):
        for k, v in step_numbers(g, r).items():
            out[k] = max(out[k], v)
        have |= {"loss", "grad", "grad_err", "grad_err_median",
                 "grad_err_tree", "update"}
        if "eval" in g:
            out["eval"] = max(out["eval"], abs(g["eval"] - r["eval"])
                              / abs(r["eval"]))
            have.add("eval")
        if "agg" in g and "finals" in g:
            out["agg"] = max(out["agg"], _rel_tree(_mean_of(g["finals"]),
                                                   g["agg"]))
            have.add("agg")
        if "clients" in g:
            n_cohort += int(list(map(int, g["clients"]))
                            != list(map(int, r["clients"])))
            have.add("cohort")
        if r.get("groups") is not None and g.get("groups") is not None:
            n_groups += sum(int(g["groups"][n] != r["groups"][n])
                            for n in r["groups"])
            have.add("groups")
        if r.get("entry") is not None and g.get("entry") is not None:
            out["entry"] = max(out["entry"], _rel_tree(g["entry"], r["entry"]))
            have.add("entry")
    if got.get("program") and ref.get("transfers"):
        for want, seen in ref["transfers"]:
            n_transfer += sum(int((x != y).sum()) for x, y in
                              zip(_leaves(want), _leaves(seen)))
        have.add("transfer")
    out.update(cohort=float(n_cohort), groups=float(n_groups),
               transfer=float(n_transfer))
    return {n: out[n] for n in NAMES if n in have}


def load_limits(root: Path, workload: str) -> Dict[str, float]:
    """The cell's limits, ``limits/<workload>.json`` ({number: {"limit":
    x, ...}}); a cell without the file has none yet."""
    path = root / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    return {k: float(v["limit"]) for k, v in json.loads(path.read_text()).items()}


def judge(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell
    limits: each present, finite and at or under its limit. A cell with
    no limits is never correct."""
    checks = {n: {"value": nums.get(n, math.nan), "limit": lim}
              for n, lim in limits.items()}
    ok = bool(limits) and all(
        n in nums and math.isfinite(nums[n]) and nums[n] <= lim
        for n, lim in limits.items())
    return ok, checks
