"""Anatomy of a DEVFT stage on the PyTorch port: shows the DGLG
similarity matrix, the spectral groups, the DBLF fusion, and the
knowledge-transfer broadcast for a real (reduced) model — the paper's
Figure 3/4 as console output, as ``examples/stage_anatomy.py`` prints it.

W is computed on ``--device`` (default cuda); the spectral clustering
runs on the host, as in ``repro_torch.core.grouping``.

    PYTHONPATH=src python examples/torch_stage_anatomy.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import build_submodel, transfer_stage
from repro_torch.core.grouping import layer_vectors, similarity_matrix
from repro_torch.launch.env import setup_environment
from repro_torch.models import transformer as T

CAPACITIES = (2, 4)
BETA = 0.1


def build_model(device="cuda"):
    """(cfg, params, lora): the 8-layer reduced llama2-7b-proxy in f32
    and a rank-4 LoRA, from seed 0 on ``device``."""
    cfg = dataclasses.replace(reduce_config(get_config("llama2-7b-proxy")),
                              n_layers=8)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(cfg, gen, torch.float32)
    lora = T.init_lora(cfg, gen, rank=4)
    return cfg, params, lora


def anatomy(cfg, params, lora):
    """Print the stage anatomy of (``params``, ``lora``) and return it:
    ``{"w": W (L, L) numpy, "stages": {capacity: {"groups", "depth",
    "dblf_err", "broadcast"}}}``."""
    stack = params["blocks"]["layers"]
    w = similarity_matrix(layer_vectors(stack, lora["layers"])).cpu().numpy()
    print("layer-similarity matrix W (Eq. 1):")
    for row in w:
        print("  " + " ".join(f"{v:+.2f}" for v in row))

    stages = {}
    for cap in CAPACITIES:
        sub = build_submodel(cfg, params, lora, cap, beta=BETA)
        groups = sub.plan["layers"]["groups"]
        depth = sub.params["blocks"]["layers"]["ln1"].shape[0]
        print(f"\nstage submodel capacity {cap}: groups = {groups}")
        print(f"  submodel depth: {depth}")
        # Eq. 5 sanity on one leaf
        leaf = stack["ln1"].cpu().numpy()
        g0 = groups[0]
        fused = leaf[g0[0]] + BETA * sum(leaf[j] - leaf[g0[0]] for j in g0)
        got = sub.params["blocks"]["layers"]["ln1"][0].cpu().numpy()
        err = float(np.abs(fused - got).max())
        print(f"  DBLF check (ln1, group 0): max|err| = {err:.2e}")
        new_lora = transfer_stage(lora, sub.lora, sub.plan)
        a_new = new_lora["layers"]["wq"]["a"].cpu().numpy()
        a_sub = sub.lora["layers"]["wq"]["a"].cpu().numpy()
        ok = all(np.allclose(a_new[j], a_sub[gi])
                 for gi, g in enumerate(groups) for j in g)
        print(f"  knowledge transfer broadcast correct: {ok}")
        stages[cap] = {"groups": groups, "depth": depth, "dblf_err": err,
                       "broadcast": ok}
    return {"w": w, "stages": stages}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where W and the submodels are computed")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (use "
                         "--device cpu)")
    setup_environment()
    cfg, params, lora = build_model(args.device)
    return dict(anatomy(cfg, params, lora), cfg=cfg, params=params,
                lora=lora)


if __name__ == "__main__":
    main()
