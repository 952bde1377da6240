"""Serving CLI: a thin shell over the continuous-batching engine.

Initializes a reduced model from a seed, builds a
:class:`~repro_torch.serving.ServingEngine` with a fixed slot pool —
optionally multi-tenant over a registry of per-request LoRA adapters —
submits a request stream, drains it, and reports time-to-first-token
and decode-only per-token latency and throughput (the warm-up step,
where the kernels are built, is excluded; prefill is counted apart).

``generate()`` is the *sequential* greedy baseline the engine is
checked against; it is kept as the reference oracle and for single-
batch use.

Every arch of the repo serves, reduced as the JAX package's CLI does:
the dense ones, granite-moe-1b-a400m (MoE), mamba2-2.7b (Mamba-2),
jamba-v0.1-52b (the hybrid order), deepseek-v3-671b (MLA, decoded in
the absorbed formulation through ``flash_decode``, and the MoE with its
shared expert), qwen2-vl-7b (M-RoPE tables at each slot's position in
all three streams; requests are text, as in the JAX package) and
whisper-tiny (the decoder; its cross-attention reads the zero cross
caches ``init_cache`` makes, since, as in the JAX package, the engine
runs no encoder).

Examples (``--device cpu`` runs the plain PyTorch versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --batch 4 --prompt-len 16 --gen 16 --requests 8 --n-adapters 3
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --batch 2 --prompt-len 8 --gen 8 --merge-lora
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch jamba-v0.1-52b --batch 2 --prompt-len 8 --gen 8 --n-adapters 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-v3-671b --batch 2 --prompt-len 4 --gen 3 --n-adapters 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch whisper-tiny --batch 2 --prompt-len 4 --gen 3 --n-adapters 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen2-vl-7b --batch 2 --prompt-len 4 --gen 3 --n-adapters 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCH_IDS, get_config, reduce_config
from repro_torch.launch.env import setup_environment
from repro_torch.lora.lora import merge_lora
from repro_torch.models import transformer as T
from repro_torch.serving import AdapterRegistry, ServingEngine, check_capacity


@torch.no_grad()
def generate(cfg, params, lora, prompts, gen: int, *, window=None,
             ring: bool = False, warmup: bool = True):
    """Greedy generation, one batch end to end (the engine's oracle).
    prompts: (B, S) int tensor on the params' device; yields
    ``(token (B, 1), step_s)`` for each of the ``gen`` decode steps.

    ``window`` caps the KV capacity; a window smaller than
    ``prompt_len + gen`` is legal only with ``ring=True`` (explicit
    sliding-window decode through the ring buffer), otherwise it raises.
    """
    b, s = prompts.shape
    dev = prompts.device
    if window is None:
        capacity = s + gen
    else:
        check_capacity(window, s, gen, ring, what="generate()")
        capacity = min(window, s + gen)
    dtype = getattr(torch, cfg.dtype)
    if warmup:
        # build and first-launch the kernels against a throwaway cache so
        # no timed step includes them
        warm = T.init_cache(cfg, b, capacity, dtype, dev)
        T.decode_step(cfg, params, lora, prompts[:, 0:1], warm)[0].cpu()
    cache = T.init_cache(cfg, b, capacity, dtype, dev)

    # teacher-forced prefill through the decode path
    tok = prompts[:, 0:1]
    for t in range(s + gen - 1):
        t0 = time.perf_counter()
        logits, cache = T.decode_step(cfg, params, lora, tok, cache)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        nxt_host = nxt.cpu()                       # waits for the device
        dt = time.perf_counter() - t0
        tok = prompts[:, t + 1: t + 2] if t + 1 < s else nxt
        if t + 1 >= s:
            yield nxt_host, dt


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ALL_ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the Hopper kernels; cpu their plain "
                         "PyTorch versions")
    ap.add_argument("--batch", type=int, default=8,
                    help="decode slot pool size (concurrent requests)")
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests to serve (default: 2x slots, so "
                         "slot recycling is exercised)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--n-adapters", type=int, default=0,
                    help="resident per-request adapters (0 = one shared "
                         "adapter; requests round-robin over adapters)")
    ap.add_argument("--merge-lora", action="store_true",
                    help="fold the shared adapter into base weights")
    ap.add_argument("--kv-capacity", type=int, default=None,
                    help="per-slot KV capacity (default prompt+gen)")
    ap.add_argument("--window", type=int, default=None,
                    help="alias for --kv-capacity (sliding window with "
                         "--ring)")
    ap.add_argument("--ring", action="store_true",
                    help="allow requests longer than capacity "
                         "(ring-buffer sliding-window decode)")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "priority"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is visible (use --device cpu)")

    setup_environment()
    cfg = reduce_config(get_config(args.arch))
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, torch.float32)

    adapters = None
    lora = None
    if args.n_adapters > 0:
        if args.merge_lora:
            ap.error("--merge-lora folds ONE adapter into the base "
                     "weights; incompatible with --n-adapters")
        adapters = AdapterRegistry.for_model(cfg, rank=8,
                                             capacity=args.n_adapters,
                                             device=args.device)
        for i in range(args.n_adapters):
            adapters.add(f"adapter/{i}", T.init_lora(cfg, gen, rank=8))
    else:
        lora = T.init_lora(cfg, gen, rank=8)
        if args.merge_lora:
            params = merge_lora(params, lora)
            lora = None
            print("LoRA merged into base weights")

    capacity = args.kv_capacity or args.window \
        or (args.prompt_len + args.gen)
    engine = ServingEngine(cfg, params, lora=lora, adapters=adapters,
                           n_slots=args.batch, kv_capacity=capacity,
                           policy=args.policy,
                           overflow="ring" if args.ring else "error")
    engine.warmup()

    n_req = args.requests or 2 * args.batch
    prompt_rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence((args.seed, 7919))))
    for i in range(n_req):
        prompt = prompt_rng.integers(0, cfg.vocab, size=args.prompt_len,
                                     dtype=np.int32)
        engine.submit(prompt, max_new_tokens=args.gen,
                      adapter=f"adapter/{i % args.n_adapters}"
                      if adapters else None,
                      priority=i % 3 if args.policy == "priority" else 0)

    t0 = time.perf_counter()
    while engine.has_work():
        engine.step()
    wall = time.perf_counter() - t0

    reqs = engine.finished
    decode_times = [dt for r in reqs for dt in r.decode_times]
    ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
    n_new = sum(len(r.generated) for r in reqs)
    prefill_s = sum(r.prefill_s for r in reqs)

    print(f"arch={args.arch} device={args.device} slots={args.batch} "
          f"requests={len(reqs)} prompt={args.prompt_len} gen={args.gen} "
          f"adapters={args.n_adapters or ('merged' if args.merge_lora else 'shared')}")
    print(f"first request: {reqs[0].generated[:16]} ...")
    print(f"TTFT p50 {_pct(ttfts, 50)*1e3:.1f} ms "
          f"(queueing + prefill; prefill total {prefill_s:.2f} s)")
    print(f"decode step p50 {_pct(decode_times, 50)*1e3:.1f} ms | "
          f"p99 {_pct(decode_times, 99)*1e3:.1f} ms "
          f"(warm-up excluded)")
    print(f"throughput {n_new / wall:.1f} tok/s "
          f"({n_new} new tokens / {wall:.2f} s serving wall)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
