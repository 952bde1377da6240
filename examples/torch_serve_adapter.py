"""Serving example on the PyTorch port: batched greedy decoding from a
fine-tuned checkpoint, with and without LoRA merging, across
architecture families — ``examples/serve_adapter.py`` on one CUDA card
(``--device cuda``, the default: ``flash_decode`` and ``moe_expert_ffn``
on the card) or on the CPU (``--device cpu``: their plain versions).

    PYTHONPATH=src python examples/torch_serve_adapter.py \
        [--arch mamba2-2.7b] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import ALL_ARCH_IDS, get_config, reduce_config
from repro_torch.launch.env import setup_environment
from repro_torch.lora import merge_lora
from repro_torch.models import transformer as T


def make_prompts(cfg, batch=4, prompt=16):
    """(batch, prompt) int32 prompt ids from seed 0, on the CPU."""
    gen = torch.Generator().manual_seed(0)
    return torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                         dtype=torch.int32)


def bench_decode(cfg, params, lora, prompts, gen=16, device="cuda"):
    """Teacher-force ``prompts`` (B, P) through ``decode_step``, then
    decode ``gen`` greedy tokens. Returns (mean seconds a step after the
    first two, the generated tokens (B, gen), every step's last logits
    (B, P + gen - 1, Vp)), the last two on the CPU."""
    batch, prompt = prompts.shape
    prompts = prompts.to(device)
    cache = T.init_cache(cfg, batch, prompt + gen, torch.float32, device)
    tok = prompts[:, :1]
    times, logits_all, generated = [], [], []
    with torch.no_grad():
        for t in range(prompt + gen - 1):
            t0 = time.perf_counter()
            logits, cache = T.decode_step(cfg, params, lora, tok, cache)
            if logits.is_cuda:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            logits_all.append(logits[:, -1])
            nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            if t + 1 < prompt:
                tok = prompts[:, t + 1: t + 2]
            else:
                tok = nxt
                generated.append(nxt)
    # skip the first steps, as the JAX example skips its compile steps
    return (sum(times[2:]) / len(times[2:]), torch.cat(generated, 1).cpu(),
            torch.stack(logits_all, 1).cpu())


def serve(arch, cfg, params, lora, prompts, device="cuda"):
    """Decode with the adapter, then on ``merge_lora``'s merged params;
    print the example's line and return both runs' (seconds a step,
    tokens, logits) under ``"adapter"`` and ``"merged"``."""
    adapter = bench_decode(cfg, params, lora, prompts, device=device)
    merged = merge_lora(params, lora)
    plain = bench_decode(cfg, merged, None, prompts, device=device)
    t_adapter, t_merged = adapter[0], plain[0]
    print(f"{arch}: per-token decode {t_adapter*1e3:.2f} ms with "
          f"adapter, {t_merged*1e3:.2f} ms merged "
          f"({t_adapter/t_merged:.2f}x)")
    return {"adapter": adapter, "merged": plain}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ALL_ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the Hopper kernels; cpu their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (use "
                         "--device cpu)")
    setup_environment()
    cfg = reduce_config(get_config(args.arch))
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = T.init_params(cfg, gen, torch.float32)
    lora = T.init_lora(cfg, gen, rank=16)
    return serve(args.arch, cfg, params, lora, make_prompts(cfg),
                 device=args.device)


if __name__ == "__main__":
    main()
