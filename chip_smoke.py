#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds every Hopper kernel from the sources in this checkout, holds
each against its plain PyTorch version on the card and times both, then
drives the serving path through the port's own entry points
(``AdapterRegistry``, ``ServingEngine``) at the full width of qwen2-7b
with random weights, and checks the card's greedy tokens against the
CPU's at a reduced size. Phases, in order:

1. device: card, power limit, versions, kernel build time;
2. kernels: ``flash_decode`` vs its plain version (max abs error, error
   scaled to each row's output size, exact zeros for empty slots) and
   times of kernel, plain version and ``scaled_dot_product_attention``
   (the yardstick; the port never calls it), beside the memory bound;
3. serving: qwen2-7b unreduced (28 layers, d 3584, 28/4 heads, vocab
   152064), bf16, 4 resident rank-8 adapters, 8 slots, 16 requests;
   ``flash_decode`` must have launched once per layer per engine step;
4. trace: device busy share over a few profiled engine steps;
5. parity: reduced qwen2-7b in f32 gives the same greedy tokens on the
   card (kernel) and on the CPU (plain version).

Every phase raises on failure, so the script exits non-zero; it also
exits non-zero, printing no result, without a CUDA card or without the
package beside it. The last lines are the ``kernels`` JSON object, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM published peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # CUDA-core f32: the kernel's dot products
CUDA_ITERS = 30            # timed launches per measurement (median)
#: kernel-vs-plain limits: (max abs error, max row-scaled error). The
#: row-scaled error is max|out - want| / max|want| over each (b, h) row
#: with valid > 0. In bf16 the kernel and its plain version round the
#: probabilities at different points (per chunk against the whole row)
#: and then round the output, so they differ by one to two bf16 ulps of
#: the row's largest |output| (2**-7 each); the limit is four. Leaving
#: out one of 16 cache chunks moves a long row by 0.1 to 0.65 of its
#: size. The absolute limit alone is the size of the outputs of long
#: rows (averages of ~1e-2) and would pass that.
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2.0 ** -5)}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, flush: torch.Tensor, iters: int = CUDA_ITERS) -> float:
    """Median device time (ms) of one ``fn()`` call. Before each timed
    call the L2 cache is flushed and the stream is held busy, so the
    events bracket the call's device work only, with a cold L2 as in the
    serving step (each layer's cache is different memory)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_phase(build):
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    seconds = build.build_all()
    print(f"[device] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(per source: {seconds})")
    for line in build.build_log("flash_decode").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[device] ptxas: {line.strip()}")
    return name, smi


def kernel_phase(flash_decode_bhrd, flash_decode_ref, seed: int = 0):
    """flash_decode vs its plain version at the serving shapes."""
    dev = "cuda"
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1)))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = [  # name, B, H, Hkv, hd, vd, C, q dtype, cache dtype
        ("path C4096 bf16", 8, 28, 4, 128, 128, 4096,
         torch.bfloat16, torch.bfloat16),
        ("path C4096 f32-q bf16-cache", 8, 28, 4, 128, 128, 4096,
         torch.float32, torch.bfloat16),
        ("path C4096 f32", 8, 28, 4, 128, 128, 4096,
         torch.float32, torch.float32),
        ("serve C1024 bf16", 8, 28, 4, 128, 128, 1024,
         torch.bfloat16, torch.bfloat16),
        ("mla-reduced f32", 4, 4, 1, 48, 32, 64,
         torch.float32, torch.float32),
        ("mla-reduced bf16", 4, 4, 1, 48, 32, 64,
         torch.bfloat16, torch.bfloat16),
    ]
    rows = {}
    for name, b, h, hkv, hd, vd, cap, qdt, kvdt in cases:
        def rand(*shape, dt):
            x = rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(x).to(dev).to(dt)
        q = rand(b, 1, h, hd, dt=qdt)
        k = rand(b, cap, hkv, hd, dt=kvdt)
        v = rand(b, cap, hkv, vd, dt=kvdt)
        fixed = [0, 1, cap - 1, cap]
        valid_np = np.array(fixed + list(rng.integers(1, cap + 1,
                                                       size=b - len(fixed))),
                            np.int32)[:b]
        valid = torch.from_numpy(valid_np).to(dev)

        out = flash_decode_bhrd(q, k, v, kv_valid_len=valid)
        want = flash_decode_ref(q, k, v, kv_valid_len=valid)
        torch.cuda.synchronize()
        check(out.dtype == want.dtype and out.shape == want.shape,
              f"{name}: {out.dtype}{tuple(out.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        size = want.float().abs().amax(-1)                # (B, 1, H)
        nonempty = (valid > 0)[:, None, None].expand_as(size)
        row_err = float((diff.amax(-1)[nonempty] / size[nonempty]).max())
        tol, row_tol = TOL[out.dtype]
        check(err <= tol, f"{name}: max abs error {err} > {tol}")
        check(row_err <= row_tol,
              f"{name}: row-scaled error {row_err} > {row_tol}")
        empty = torch.from_numpy(valid_np == 0).to(dev)
        check(bool((out[empty] == 0).all()), f"{name}: valid == 0 not zero")

        live = int(valid_np.clip(0, cap).sum())
        esz_kv = k.element_size()
        bytes_moved = (q.numel() * q.element_size() + valid.numel() * 4
                       + live * hkv * (hd + vd) * esz_kv
                       + out.numel() * out.element_size())
        flops = 2 * live * h * (hd + vd)
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
        bound_ms = 1e3 * max(t_bytes, t_ops)

        ms = time_cuda(lambda: flash_decode_bhrd(q, k, v, kv_valid_len=valid),
                       flush)
        plain_ms = time_cuda(
            lambda: flash_decode_ref(q, k, v, kv_valid_len=valid), flush)
        # yardstick only: one PyTorch call for the same function
        qs = q.to(kvdt).transpose(1, 2)                  # (B, H, 1, hd)
        ks = k.transpose(1, 2).contiguous()              # (B, Hkv, C, hd)
        vs = v.transpose(1, 2).contiguous()
        mask = (torch.arange(cap, device=dev)[None, :]
                < valid[:, None])[:, None, None, :]      # (B, 1, 1, C)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = time_cuda(
            lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True), flush)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms,
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations",
                          library_ms=library_ms)
        print(f"[kernel] flash_decode {name}: B={b} H={h}/{hkv} hd={hd} "
              f"vd={vd} C={cap} valid={valid_np.tolist()} err={err:.3g} "
              f"(tol {tol}) row-scaled {row_err:.3g} (tol {row_tol:.3g}) "
              f"| kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.2f} us ({bytes_moved / 1e6:.2f} MB, "
              f"{100 * bound_ms / ms:.1f}% of bound)")
    del flush
    return rows


def serving_phase(seed: int = 0):
    """qwen2-7b at full width through the multi-tenant engine."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode_bhrd
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterRegistry, ServingEngine

    cfg = get_config("qwen2-7b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab, cfg.dtype)
          == (28, 3584, 28, 4, 128, 18944, 152064, "bfloat16"),
          f"qwen2-7b config changed: {cfg}")
    n_slots, capacity, n_req, gen_len, n_adapters = 8, 1024, 16, 32, 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, g)
    registry = AdapterRegistry.for_model(cfg, rank=8, capacity=n_adapters)
    for i in range(n_adapters):
        lora = T.init_lora(cfg, g, rank=8)
        for stack in lora.values():
            for ab in stack.values():
                ab["b"].normal_(0.0, 0.02, generator=g)   # nonzero adapters
        registry.add(f"adapter/{i}", lora)
    engine = ServingEngine(cfg, params, adapters=registry, n_slots=n_slots,
                           kv_capacity=capacity)
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in _leaves(params))
    print(f"[serve] qwen2-7b full width: {n_param / 1e9:.3f} B params "
          f"({sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9:.2f} GB "
          f"{cfg.dtype}), set-up {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(np.random.SeedSequence((seed, 2)))
    lens = rng.integers(16, 513, size=n_req)
    prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
               for n in lens]

    flash_decode_bhrd.launches = 0
    t_warm = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t_warm
    reqs = [engine.submit(p, max_new_tokens=gen_len,
                          adapter=f"adapter/{i % n_adapters}")
            for i, p in enumerate(prompts)]
    steps = 1                                            # the warm-up step
    t0 = time.perf_counter()
    while engine.has_work():
        engine.step()
        steps += 1
    wall = time.perf_counter() - t0
    launches = flash_decode_bhrd.launches

    check(all(r.done for r in reqs), "not every request finished")
    for r in reqs:
        toks = r.tokens
        check(len(toks) == gen_len, f"request {r.rid}: {len(toks)} tokens")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"request {r.rid}: token outside the vocab {toks}")
    check(launches == cfg.n_layers * steps,
          f"flash_decode launched {launches} times for {steps} steps x "
          f"{cfg.n_layers} layers")

    decode_times = [dt for r in reqs for dt in r.decode_times]
    ttft = [r.ttft_s for r in reqs]
    n_new = sum(len(r.generated) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] {n_req} requests, prompts {int(lens.min())}-"
          f"{int(lens.max())} (sum {int(lens.sum())}), gen {gen_len}, "
          f"{n_slots} slots, capacity {capacity}, {n_adapters} adapters")
    print(f"[serve] engine steps {steps} (warm-up {warm_s:.2f} s), "
          f"flash_decode launches {launches} = {cfg.n_layers} x {steps}")
    print(f"[serve] TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms | "
          f"decode step p50 {np.percentile(decode_times, 50) * 1e3:.2f} ms "
          f"p99 {np.percentile(decode_times, 99) * 1e3:.2f} ms "
          f"({len(decode_times)} samples) | engine step mean "
          f"{wall / (steps - 1) * 1e3:.2f} ms | {n_new / wall:.1f} tok/s "
          f"({n_new} tokens / {wall:.2f} s) | max memory allocated "
          f"{peak / 2**30:.2f} GiB")

    # finite logits: one more step of the same model on a fresh cache
    cache = T.init_cache(cfg, n_slots, capacity, device="cuda")
    tok = torch.from_numpy(np.stack([r.tokens[-1:] for r in reqs[:n_slots]]))
    with torch.no_grad():
        logits, _ = T.decode_step(cfg, params, None, tok.cuda(), cache)
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "non-finite logits")
    return engine, prompts, steps, launches


def trace_phase(engine, prompts):
    """Device busy share over a few profiled steps of the same engine."""
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts[:engine.scheduler.n_slots]):
        engine.submit(p[:16], max_new_tokens=8,
                      adapter=f"adapter/{i % len(engine.adapters)}")
    for _ in range(4):                                   # into steady state
        engine.step()
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while engine.has_work():
        engine.step()
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not kernels:
        print("[trace] the profiler saw no device activity: busy share "
              "not measured")
        return
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    print(f"[trace] {n} profiled steps: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}%"
          f", idle {100 - 100 * busy_us / 1e6 / wall:.1f}%), "
          f"{len(kernels) // n} kernels/step")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[trace]   {t / 1e3 / n:.3f} ms/step, {c // n} calls/step: "
              f"{name[:90]}")


def parity_phase(seed: int = 0):
    """Reduced qwen2-7b, f32: the card (kernel) and the CPU (plain
    version) give the same greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.interop import tree_map
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterRegistry, ServingEngine

    cfg = dataclasses.replace(reduce_config(get_config("qwen2-7b")),
                              dtype="float32")
    g = torch.Generator(device="cpu").manual_seed(seed)
    params = T.init_params(cfg, g)
    adapters = []
    for _ in range(2):
        lora = T.init_lora(cfg, g, rank=4)
        for stack in lora.values():
            for ab in stack.values():
                ab["b"].normal_(0.0, 0.05, generator=g)
        adapters.append(lora)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 3)))
    prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
               for n in (5, 9, 12, 7)]
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t, d=dev: t.to(d), params)
        reg = AdapterRegistry(tree_map(lambda t, d=dev: t.to(d), adapters[0]),
                              capacity=2)
        for i, lora in enumerate(adapters):
            reg.add(f"a{i}", tree_map(lambda t, d=dev: t.to(d), lora))
        eng = ServingEngine(cfg, p, adapters=reg, n_slots=2, kv_capacity=24)
        reqs = [eng.submit(pr, max_new_tokens=8, adapter=f"a{i % 2}")
                for i, pr in enumerate(prompts)]
        while eng.has_work():
            eng.step()
        out[dev] = np.stack([r.tokens for r in reqs])
    check(np.array_equal(out["cuda"], out["cpu"]),
          f"greedy tokens differ:\ncuda {out['cuda']}\ncpu  {out['cpu']}")
    print(f"[parity] reduced qwen2-7b f32, 4 requests x 8 tokens, 2 "
          f"adapters: cuda == cpu {out['cuda'][0].tolist()} ...")


def _leaves(tree):
    from repro_torch.interop import tree_leaves
    return tree_leaves(tree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import flash_decode_bhrd
    from repro_torch.kernels.ref import flash_decode_ref
    from repro_torch.launch.serve import setup_numerics

    t_start = time.perf_counter()
    setup_numerics()
    name, smi = device_phase(build)
    rows = kernel_phase(flash_decode_bhrd, flash_decode_ref)
    engine, prompts, steps, launches = serving_phase()
    trace_phase(engine, prompts)
    del engine
    torch.cuda.empty_cache()
    parity_phase()

    row = rows["path C4096 bf16"]
    kernels = {"kernels": [dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:135",
        launches=launches, **row)]}
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
