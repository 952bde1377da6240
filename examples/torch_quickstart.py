"""Quickstart on the PyTorch port: the DEVFT loop as one spec + one call.

The port's counterpart of ``examples/quickstart.py``: builds a small
LLaMA-style model, runs 3 developmental stages of federated LoRA
fine-tuning on synthetic non-IID data, and prints the per-round losses +
resource accounting. The whole experiment is the ``quickstart`` preset,
run through ``repro_torch.experiments.run_experiment`` on one CUDA card
(``--device cuda``, the default: the Hopper kernels) or on the CPU
(``--device cpu``: their plain PyTorch versions).

    PYTHONPATH=src python examples/torch_quickstart.py [--rounds N] \
        [--device cpu]
"""
import argparse

import torch

from repro_torch.experiments import get_preset, run_experiment
from repro_torch.launch.env import setup_environment


def build_spec(rounds=None):
    """The ``quickstart`` preset, with ``rounds`` overriding its count."""
    spec = get_preset("quickstart")
    return spec.replace(rounds=rounds) if rounds else spec


def run(spec, *, device="cuda", params=None, lora=None):
    """Run ``spec`` on ``device`` and print what ``quickstart.py`` prints;
    ``params``/``lora`` replace the engine's own initial trees (tests
    hand in the JAX package's). Returns the ``RunResult``."""
    cfg = spec.build_cfg()
    print(f"model: {cfg.arch_id} ({cfg.n_layers}L d={cfg.d_model})")
    print(f"spec : {spec.to_json(indent=None)}\n")

    def show(log):
        print(f"  round {log.round:2d} | stage {log.stage} "
              f"(submodel {log.capacity}L) | eval loss {log.eval_loss:.4f} "
              f"| uplink {log.comm_bytes_up/1e6:.2f} MB")

    result = run_experiment(spec, round_progress=show, params=params,
                            lora=lora, device=device)
    logs = result.logs
    total = sum(l.comm_bytes_up + l.comm_bytes_down for l in logs)
    print(f"\nfinal loss {logs[-1].eval_loss:.4f} | total comm "
          f"{total/1e6:.1f} MB | total flops "
          f"{sum(l.flops for l in logs):.3g}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=None,
                    help="override the preset's round count (CI uses 4)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the Hopper kernels; cpu their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (use "
                         "--device cpu)")
    setup_environment()
    # a reduced llama-family config (the paper's subject, CPU-sized),
    # 8 clients with Dirichlet(0.5) non-IID mixtures of a shared task,
    # DEVFT with capacities 2 -> 4 -> 8
    return run(build_spec(args.rounds), device=args.device)


if __name__ == "__main__":
    main()
