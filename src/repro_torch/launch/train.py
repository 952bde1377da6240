"""Federated fine-tuning CLI — a thin shell over
``repro_torch.experiments`` (the JAX package's ``repro.launch.train``:
the same flags, specs and output lines, plus ``--device``).

Every run is an :class:`ExperimentSpec`: the CLI resolves a base spec
(``--preset``, default ``paper-appendix-b``, or ``--spec file.json``),
applies any flag overrides, and hands it to ``run_experiment``. Flag
defaults therefore live in ONE place (the spec / FedConfig), not here.

``--dump-spec`` prints the fully-resolved spec as JSON and exits; the
output re-run via ``--spec`` reproduces the identical trajectory.

Runs on the card (``--device cuda``, the default: the Hopper kernels)
unless ``--device cpu`` is given (their plain PyTorch versions). Writes
``<arch>_<method>_s<seed>.json`` (the round logs), ``.result.json``
and ``.ckpt`` (``{"lora": final LoRA}`` in the JAX package's checkpoint
format, ``repro_torch.checkpoint``) under ``--out``.

Example:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --preset bench-tiny --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.train --method devft \
        --arch granite-moe-1b-a400m --full --rounds 4 --n-stages 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch jamba-v0.1-52b --method devft --layers 8 --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch deepseek-v3-671b --method devft --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen2-vl-7b --method devft --rounds 2

qwen2-vl-7b trains on text-only batches, as in the JAX package (its
vision prefix runs when a batch carries ``vision_embeds``). The
federated data carry no ``audio_embeds``, so whisper-tiny raises
``KeyError: 'audio_embeds'`` here exactly as the JAX CLI does.
    PYTHONPATH=src python -m repro_torch.launch.train --dump-spec > run.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.checkpoint import save
from repro_torch.configs import ALL_ARCH_IDS
from repro_torch.experiments import ExperimentSpec, get_preset, run_experiment
from repro_torch.federated import (
    POLICIES,
    WEIGHTINGS,
    available_aggregations,
    available_fleets,
    available_methods,
)
from repro_torch.kernels.dispatch import BACKENDS
from repro_torch.launch.env import setup_environment

DEFAULT_PRESET = "paper-appendix-b"


def build_parser() -> argparse.ArgumentParser:
    """All spec-mapped options default to None — "not overridden" — so
    the resolved base spec is the single source of defaults."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spec", default=None, metavar="FILE.json",
                    help="load the base ExperimentSpec from a JSON file")
    ap.add_argument("--preset", default=None,
                    help=f"named base spec (default {DEFAULT_PRESET!r})")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the resolved spec as JSON and exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the Hopper kernels; cpu their plain "
                         "PyTorch versions")
    # model
    ap.add_argument("--arch", default=None, choices=ALL_ARCH_IDS)
    ap.add_argument("--full", dest="full", action="store_const",
                    const=True, default=None,
                    help="use the full (cluster-scale) config")
    ap.add_argument("--no-full", dest="full", action="store_const",
                    const=False,
                    help="force the reduced config (override a full "
                         "spec file)")
    ap.add_argument("--layers", type=int, default=None,
                    help="override depth (reduced runs)")
    ap.add_argument("--kernel-backend", default=None,
                    choices=list(BACKENDS),
                    help="model hot-path kernels: pallas (the Hopper "
                         "kernels) | reference (their plain versions) | "
                         "auto (the kernels on the card; the CPU always "
                         "runs the plain versions)")
    # data
    ap.add_argument("--alpha", type=float, default=None,
                    help="Dirichlet non-IID concentration")
    ap.add_argument("--noise", type=float, default=None,
                    help="label-noise fraction")
    # federated
    ap.add_argument("--method", default=None, choices=available_methods())
    ap.add_argument("--aggregation", default=None,
                    choices=available_aggregations() + ["none"],
                    help="override the method's aggregator (Table 4); "
                         "'none' clears a spec file's override")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=None,
                    help="eval cadence in rounds (skipped rounds carry "
                         "the last eval forward; the final round always "
                         "evaluates)")
    ap.add_argument("--mesh", default=None,
                    choices=["none", "host", "production"],
                    help="mesh the round engine runs on: none (one "
                         "device), host (1x1 on --device), production "
                         "(16x16, a world of 256 ranks); 'none' clears a "
                         "spec file's setting")
    ap.add_argument("--population", default=None,
                    choices=available_fleets(),
                    help="device fleet the clients are drawn from "
                         "(heterogeneous-client simulation)")
    ap.add_argument("--straggler-policy", default=None,
                    choices=list(POLICIES),
                    help="wait for stragglers, accept their partial "
                         "work, or drop them at the deadline")
    ap.add_argument("--weighting", default=None, choices=list(WEIGHTINGS),
                    help="aggregation weights: uniform, example-count "
                         "(weighted FedAvg), or fednova step "
                         "normalization")
    ap.add_argument("--deadline-factor", type=float, default=None,
                    help="round deadline as a multiple of the reference "
                         "device's full-work time")
    ap.add_argument("--n-clients", type=int, default=None)
    ap.add_argument("--sample-frac", type=float, default=None)
    ap.add_argument("--k-local", type=int, default=None)
    ap.add_argument("--local-batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lora-rank", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--n-stages", type=int, default=None)
    ap.add_argument("--growth", type=float, default=None)
    ap.add_argument("--initial-capacity", type=int, default=None)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--grouping", default=None,
                    choices=["dglg", "random", "even"])
    ap.add_argument("--fusion", default=None,
                    choices=["dblf", "sum", "rone"])
    ap.add_argument("--lr-stage-factor", type=float, default=None)
    ap.add_argument("--flora-ranks", default=None, metavar="R1,R2,...",
                    type=lambda s: tuple(int(r) for r in s.split(",")),
                    help="per-client LoRA ranks (FLoRA heterogeneity)")
    ap.add_argument("--seed", type=int, default=None)
    # budget / pretrain
    ap.add_argument("--pretrain-steps", type=int, default=None)
    # output
    ap.add_argument("--out", default="experiments/train")
    return ap


_SPEC_FIELDS = tuple(f.name for f in dataclasses.fields(ExperimentSpec))


def spec_from_args(args: argparse.Namespace) -> ExperimentSpec:
    if args.spec and args.preset:
        raise SystemExit("--spec and --preset are mutually exclusive")
    base = ExperimentSpec.load(args.spec) if args.spec \
        else get_preset(args.preset or DEFAULT_PRESET)
    overrides = {f: getattr(args, f) for f in _SPEC_FIELDS
                 if getattr(args, f, None) is not None}
    if overrides.get("aggregation") == "none":
        overrides["aggregation"] = None
    if overrides.get("mesh") == "none":
        overrides["mesh"] = None
    return base.replace(**overrides)


def main(argv=None):
    args = build_parser().parse_args(argv)
    spec = spec_from_args(args)
    if args.dump_spec:
        print(spec.to_json())
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (use "
                         "--device cpu)")
    setup_environment()

    def progress(log):
        print(f"round {log.round:3d} stage {log.stage} cap {log.capacity:3d}"
              f" loss {log.eval_loss:.4f} acc {log.eval_acc:.3f}"
              f" upMB {log.comm_bytes_up/1e6:.2f}"
              f" t {log.sim_time_s:.3g}s"
              + (f" dropped {log.n_dropped}" if log.n_dropped else ""),
              flush=True)

    result = run_experiment(spec, round_progress=progress,
                            device=args.device)
    logs = result.logs
    os.makedirs(args.out, exist_ok=True)
    tagbase = f"{spec.arch}_{spec.method}_s{spec.seed}"
    # bare round-log dump: the pre-spec CLI's artifact contract, kept
    # for downstream scripts; the .result.json artifact embeds the same
    # logs plus the spec/metrics and is the re-runnable form
    with open(os.path.join(args.out, tagbase + ".json"), "w") as f:
        json.dump([dataclasses.asdict(l) for l in logs], f, indent=1)
    result.save(os.path.join(args.out, tagbase + ".result.json"))
    save(os.path.join(args.out, tagbase + ".ckpt"),
         {"lora": result.final_lora})
    total_up = sum(l.comm_bytes_up for l in logs)
    print(f"done in {result.wall_s:.0f}s | final loss "
          f"{logs[-1].eval_loss:.4f} acc {logs[-1].eval_acc:.3f} | "
          f"total uplink {total_up/1e6:.1f} MB | "
          f"flops {sum(l.flops for l in logs):.3g} | "
          f"sim time {logs[-1].sim_time_s:.3g}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
