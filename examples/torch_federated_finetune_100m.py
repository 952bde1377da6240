"""End-to-end example on the PyTorch port: federated-fine-tune a
~100M-parameter model for a few hundred optimizer steps with DEVFT —
``examples/federated_finetune_100m.py`` on one CUDA card (``--device
cuda``, the default: ``lora_matmul`` and ``flash_attention`` on the
card) or on the CPU (``--device cpu``: their plain versions).

This is the "real" end-to-end example: a 12-layer d=512 model
(~100M params incl. embeddings), 20 clients, 10% sampling, K=5 local
steps — so `rounds * sampled * K` optimizer steps total. Runs a spec
sweep over the method axis (DEVFT vs FedIT by default, same data and
seed) and writes loss curves to
experiments/examples/federated_100m_torch.json.

    PYTHONPATH=src python examples/torch_federated_finetune_100m.py \
        [--rounds 30] [--method both] [--device cpu]
"""
import argparse
import json
import math
import os

import torch

from repro_torch.experiments import ExperimentSpec, sweep
from repro_torch.federated import available_methods
from repro_torch.interop import tree_leaves
from repro_torch.launch.env import setup_environment
from repro_torch.launch.specs import param_specs


def build_spec(args) -> ExperimentSpec:
    # ~100M params: 12L, d=512, ff=2048, vocab 32k
    return ExperimentSpec(
        reduced={"n_layers": 12, "d_model": 512, "n_heads": 8,
                 "n_kv_heads": 8, "d_ff": 2048, "vocab": 32000},
        layers=12,
        n_clients=20, sample_frac=0.1, k_local=args.k_local,
        local_batch=8, seq=args.seq, rounds=args.rounds,
        lora_rank=16, lr=3e-3, n_stages=3)


def param_count(cfg) -> int:
    """The model's parameters, counted on meta tensors."""
    return sum(math.prod(l.shape) for l in tree_leaves(param_specs(cfg)))


def summary(res) -> dict:
    """One method's entry of the output JSON."""
    logs = res.logs
    return {
        "losses": [l.eval_loss for l in logs],
        "acc": [l.eval_acc for l in logs],
        "comm_MB": sum(l.comm_bytes_up + l.comm_bytes_down
                       for l in logs) / 1e6,
        "flops": sum(l.flops for l in logs),
        "wall_s": res.wall_s,
    }


def run(base, methods, *, device="cuda", out="experiments/examples"):
    """Sweep ``base`` over ``methods`` on ``device``, print the example's
    lines, write ``out``/federated_100m_torch.json; return the sweep's
    ``RunResult`` list."""
    cfg = base.build_cfg()
    n = param_count(cfg)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.padded_vocab} "
          f"-> {n/1e6:.0f}M params")
    os.makedirs(out, exist_ok=True)

    def progress(i, total, spec):
        steps = spec.rounds * 2 * spec.k_local
        print(f"\n=== {spec.method}: {spec.rounds} rounds x 2 clients x "
              f"{spec.k_local} local steps = {steps} optimizer steps ===")

    def show_round(l):
        print(f"  round {l.round:3d} stage {l.stage} cap {l.capacity:2d} "
              f"loss {l.eval_loss:.4f} acc {l.eval_acc:.3f}", flush=True)

    runs = sweep(base, {"method": methods}, progress=progress,
                 round_progress=show_round, device=device)
    results = {}
    for res in runs:
        results[res.spec.method] = summary(res)
        print(f"{res.spec.method}: final loss {res.logs[-1].eval_loss:.4f} "
              f"({res.wall_s:.0f}s, "
              f"{results[res.spec.method]['comm_MB']:.1f} MB comm)")

    with open(os.path.join(out, "federated_100m_torch.json"), "w") as f:
        json.dump(results, f, indent=1)
    if len(results) == 2:
        d, f_ = results["devft"], results["fedit"]
        print(f"\nDEVFT vs FedIT: comm x{f_['comm_MB']/d['comm_MB']:.2f} "
              f"less, flops x{f_['flops']/d['flops']:.2f} less, final "
              f"loss {d['losses'][-1]:.4f} vs {f_['losses'][-1]:.4f}")
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--method", default="both",
                    choices=["both"] + available_methods())
    ap.add_argument("--k-local", type=int, default=5)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--out", default="experiments/examples")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the Hopper kernels; cpu their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (use "
                         "--device cpu)")
    setup_environment()
    methods = ["devft", "fedit"] if args.method == "both" else [args.method]
    return run(build_spec(args), methods, device=args.device, out=args.out)


if __name__ == "__main__":
    main()
