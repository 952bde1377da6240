"""CLI: ``python -m repro_torch.analysis [paths...]``.

The default target is ``src/repro_torch`` (its Python and CUDA
sources); the committed baseline (``src/repro_torch/analysis/
baseline.json``) is applied when it exists:

    python -m repro_torch.analysis              # exit 1 on any non-
                                                # baselined finding OR
                                                # stale baseline entry
    python -m repro_torch.analysis --contracts  # contract layer C001-
                                                # C003 over meta tensors
    python -m repro_torch.analysis --contracts --device cuda
                                                # C001/C003 on the card
    python -m repro_torch.analysis --rule R001 --rule R002
    python -m repro_torch.analysis --no-baseline        # show everything
    python -m repro_torch.analysis --write-baseline     # re-grandfather
    python -m repro_torch.analysis --format github      # CI annotations
    python -m repro_torch.analysis --list-rules

The JAX package's ``--lowered``, ``--surface`` and
``--write-fingerprints`` check XLA programs; the port has none.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.core import (
    DEFAULT_BASELINE,
    DEFAULT_TARGET,
    analyze_paths,
)
from repro_torch.analysis.findings import (
    apply_baseline,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.registry import all_rules


def _gh_escape(s: str) -> str:
    """GitHub workflow-command escaping for annotation messages."""
    return (s.replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A"))


def render_github(f) -> str:
    """One ``::error`` workflow command per finding — GitHub renders
    these as inline PR annotations when emitted from a CI step."""
    return (f"::error file={f.path},line={f.line},col={f.col + 1},"
            f"title={f.rule}::{_gh_escape(f.message)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's project lint: the JAX package's rules "
                    "that have a torch meaning, plus the contract layer")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to analyze (default: "
                         + ", ".join(str(p) for p in DEFAULT_TARGET) + ")")
    ap.add_argument("--contracts", action="store_true",
                    help="run the contract checkers (every registered "
                         "kernel, strategy round program and serving "
                         "step against its declared contract) instead "
                         "of the AST rules")
    ap.add_argument("--device", default="meta",
                    help="with --contracts: the device C001 and C003 "
                         "run on (meta: shapes only, nothing allocated; "
                         "cpu; cuda: the hand kernels on the card); "
                         "C002 always runs on meta")
    ap.add_argument("--rule", action="append", dest="rules", default=None,
                    metavar="R00X", help="run only these rule IDs "
                    "(repeatable)")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         "when it exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report grandfathered findings too")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to the baseline "
                         "and exit")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--format", choices=("text", "github", "json"),
                    default="text", dest="fmt",
                    help="output format: plain text (default), GitHub "
                         "workflow annotations, or JSON")
    args = ap.parse_args(argv)
    fmt = args.fmt

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id}  {r.name}  [{', '.join(r.languages)}]\n"
                  f"    {r.summary}\n    history: {r.history}")
        from repro_torch.analysis.contracts import CONTRACT_RULES
        for rid, summary in CONTRACT_RULES.items():
            print(f"{rid}  (contract, via --contracts)\n    {summary}")
        return 0

    stats = None
    if args.contracts:
        if args.paths:
            ap.error("--contracts checks registered surfaces, not "
                     "source paths")
        if args.rules:
            ap.error("--rule filters AST rules; contract checks run "
                     "as one suite")
        from repro_torch.analysis.contracts import run_contracts
        findings, stats = run_contracts(device=args.device)
    else:
        paths = args.paths or list(DEFAULT_TARGET)
        findings = analyze_paths(paths, rules=args.rules)

    baseline_path = args.baseline or (
        DEFAULT_BASELINE if DEFAULT_BASELINE.exists() else None)

    if args.write_baseline:
        target = args.baseline or str(DEFAULT_BASELINE)
        save_baseline(findings, target)
        print(f"wrote {len(findings)} finding(s) to {target}")
        return 0

    suppressed, stale = [], []
    if baseline_path and not args.no_baseline:
        baseline = load_baseline(str(baseline_path))
        # staleness is only decidable for rules that ran: a --contracts
        # run never produces R* findings, and --rule R001 never
        # produces R002, so entries for rules that did not run are out
        # of scope for this invocation rather than fixed.
        if args.contracts:
            from repro_torch.analysis.contracts import CONTRACT_RULES
            ran = set(CONTRACT_RULES)
        else:
            ran = (set(args.rules) if args.rules
                   else {r.id for r in all_rules()})
        baseline = {k: n for k, n in baseline.items() if k[0] in ran}
        findings, suppressed, stale = apply_baseline(findings, baseline)

    if fmt == "json":
        out = {"findings": [f.__dict__ for f in findings]}
        if stats is not None:
            out["stats"] = stats
        print(json.dumps(out, indent=1))
    elif fmt == "github":
        for f in findings:
            print(render_github(f))
        for key in stale:
            print(f"::error file={key[1]},line=1,title=stale-baseline::"
                  + _gh_escape(f"stale baseline entry (fix landed — "
                               f"remove it): {key[0]} {key[2]!r}"))
    else:
        for f in findings:
            print(f.render())
        for key in stale:
            print(f"stale baseline entry (fix landed — remove it): "
                  f"{key[0]} {key[1]}: {key[2]!r}")
        if stats is not None:
            print("enumerated: " + "  ".join(
                f"{k}={v}" for k, v in stats.items()))
        print(f"{len(findings)} finding(s)"
              + (f", {len(suppressed)} baselined" if suppressed else "")
              + (f", {len(stale)} stale baseline entr"
                 f"{'y' if len(stale) == 1 else 'ies'}" if stale else ""))
    return 1 if (findings or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
