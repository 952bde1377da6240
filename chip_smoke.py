#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds every Hopper kernel from the sources in this checkout, holds
each against its plain PyTorch version on the card and times both, then
drives the serving path (qwen2-7b, granite-moe-1b-a400m, mamba2-2.7b,
jamba-v0.1-52b, deepseek-v3-671b, qwen2-vl-7b and whisper-tiny), the
training path (llama2-7b-proxy, FedAvg rounds; whisper-tiny's
encoder-decoder order; qwen2-vl-7b with its vision prefix), the other
federated methods through a sweep, the train->serve hand-off (a FedSA
round exported, checkpointed and served) and DevFT's training entry
point (granite-moe-1b-a400m, mamba2-2.7b, jamba-v0.1-52b,
deepseek-v3-671b and qwen2-vl-7b, four stages each, then each run's
global adapter served; whisper-tiny's submodels; granite's run again on
the 1x1 device mesh, and its train step on each MoE path, the
expert-parallel one included) through the port's own
entry points at full width with random weights (jamba's and deepseek's
depth cut), checks card-vs-CPU parity at reduced sizes, and runs the
four examples (``examples/torch_*.py``) through their ``main``. Phases, in
order:

1. device: card, power limit, versions, kernel build time, ptxas lines
   (registers, spills, performance-loss warnings);
2. kernels: ``flash_decode``, ``lora_matmul``, ``flash_attention``,
   ``moe_expert_ffn`` and ``ssd_scan`` vs their plain versions (max abs
   error and error scaled to each row's output size; exact zeros for
   empty MoE rows and empty decode slots; ``flash_decode`` with the
   variant of every case, a cache holding NaN at or past each slot's
   valid length (bit-equal to the kernel on zeros there), and at the
   path shapes the first design's (``fma``) time, the times after a
   clean (read) L2 flush, host time and CUDA kernels per call;
   ``ssd_scan`` also vs the f32 sequential oracle, with ragged S, G > 1,
   underflowing decays, empty dt rows, 16 chunks (S 4096), x/b/c two
   elements off TMA's alignment (planned ``fma``), jamba's N 16 and chunks
   shorter than a tile, each case with its variant, two calls' bit-
   equality, the error's margin under both limits, the workspace, host
   time and CUDA kernels per call, and on ``mma`` cases the first
   design's (``fma``) time;
   ``moe_expert_ffn`` with the variant of every case (``wgmma`` for
   bf16, ``fma`` for f32), padding, two calls' bit-equality, host time
   and CUDA kernels per call (its kernels' registers and spills are
   among phase 1's ptxas lines), on bf16 cases the first design's
   (``mma_sync``) time, and
   on cases with empty rows the call with each expert's fill (the same
   bits; zeros past the fill even where buf holds values there) with
   its time and a bound that counts the live rows only;
   ``lora_matmul`` at ranks 32, 65 and 128 and ragged shapes, also vs
   an f64 oracle at the llama shape, with its variant, padding, pre-pass
   time, the other tile width's time and host time per call;
   at every decode shape a serving phase launches (``SERVED_DECODE``,
   ``SERVED_MOE``; each serving phase checks that its shapes are
   there): ``flash_decode`` at qwen2-7b's B8 C1024 H28/4 hd128,
   granite's B8 C1024 H16/8 hd64, jamba's B8 C1024 H32/8 hd128,
   granite's and jamba's DevFT serve B4 C24, and deepseek-v3's absorbed
   MLA decode B8 C1024 and B4 C24 H128/1 hd576 vd512 (planned ``fma``;
   every one but qwen2-7b's with two calls bit-equal), each with its
   bytes and operations bounds, and ``moe_expert_ffn`` at granite's E32
   C8 d1024 ff512, jamba's E16 C8 d4096 ff14336 and deepseek's E256 C8
   d7168 ff2048 with the fill (one 128-row tile holds an expert's 8
   rows); at the DevFT training shapes of jamba and deepseek:
   ``moe_expert_ffn`` E16 C640 d4096 ff14336 and E256 C160 d7168 ff2048
   (the f32-inside version built 16 experts at a time), the
   deepseek-v3-8l.devft cell's share E8 C8192 d7168 ff2048 with about
   256 rows of each expert live (the fill), and at the ep
   path's E32 C2048 d1024 ff512 with the fill, ``lora_matmul``
   on jamba's in_proj, out_proj and W_v and deepseek's W_q_b and W_kv_b,
   ``flash_attention`` at jamba's B4 S1024 H32/8 D128 and at MLA's
   training shape B16 S512 H128 D192 (v's 128 columns zero-padded, as
   ``attend`` pads them: ``mma_sync``, the padded outputs exactly zero),
   and ``ssd_scan``
   at jamba's B4 S1024 H128 P64 N16; at the frontend orders' shapes:
   ``flash_attention`` non-causal at whisper's encoder B4 S1500 H6 D64
   (the first case, with the first design's time), whisper's decoder B4
   S448 causal, qwen2-vl's B4 S1024 and S1280 H28/4 D128;
   ``lora_matmul`` at qwen2-vl's W_q K3584 N3584 and W_v N512 (M4096
   and M5120) and whisper's K384 N384; ``flash_decode`` at whisper's B8
   C448 H6/6 hd64 and qwen2-vl's DevFT serve B4 C24 H28/4;
   ``flash_attention`` with the variant of every case, ragged S, windows
   inside and across tiles, GQA, strided views of a fused QKV tensor,
   one-hot V (the output is the probability matrix) and a grid smaller
   than the card, at the path shapes also the first design's
   (``mma_sync``) time and host time per call,
   and at the llama shape the error of the two row-sum denominators)
   and times of kernel, plain version and a PyTorch yardstick the port
   never calls, beside the bound;
   then autotune: ``lora_matmul``, ``flash_attention``,
   ``moe_expert_ffn`` and ``flash_decode`` tuned at their path shapes
   into a temporary cache (each candidate plan timed after a clean L2
   flush, the default first), default and tuned times and knobs, the
   cache read back, every tuned call resolved through ``dispatch``
   and held against its plain version, and the host time of one call
   through the raw wrapper and through ``dispatch`` without and with
   the cache installed;
   then contracts: ``repro_torch.analysis``'s C001 on the card (every
   backend of every kernel over its contract shape family on real
   tensors: ``pallas`` and ``auto`` are the hand kernels, each launch
   count rising by exactly its cases x 2), C003 on the card (one step
   of a reduced qwen2-7b, deepseek-v3-671b and mamba2-2.7b engine in the
   base, shared and multi-tenant modes) and C002 on meta tensors; zero
   findings; then each hand kernel once at the first case of its family,
   in f32 and in bf16, under ``guard_syncs("warn")``: the synchronizing
   calls each wrapper made (a count, not a check);
3. serving: qwen2-7b unreduced (28 layers, d 3584, 28/4 heads, vocab
   152064), then granite-moe-1b-a400m, mamba2-2.7b, jamba-v0.1-52b,
   deepseek-v3-671b, qwen2-vl-7b (text requests) and whisper-tiny (its
   decoder at capacity 448, over the zero cross caches the engine
   keeps, as in the JAX package) at full width (jamba's depth cut to
   one interleave period, 8 of its 32 layers, stacks 3 / 4 / 1;
   deepseek's to its 3 dense and 2 MoE layers of 61, 53.2 GB; the phase
   says so), bf16, 4 resident
   nonzero rank-8 adapters, 8 slots, capacity 1024, 16 requests of 16 to
   512 (qwen2-7b) or 256 prompt and 32 generated tokens; exact launches
   per engine step (``flash_decode`` once per attention layer, every
   call on ``tma_mma``, on deepseek's MLA ``fma``; ``moe_expert_ffn``
   once per MoE layer, every
   call on ``wgmma`` with the fill, unpadded; no training kernel; every
   kernel 0 on mamba2, whose decoding the JAX package keeps plain);
   decode p50/p99, TTFT p50, tok/s, peak memory, finite logits; one
   engine step under ``guard_syncs("warn")`` with its synchronizing
   calls counted, and after the run the engine's ``StepContract``
   (int32 next tokens, the cache's shapes and dtypes kept) held by
   ``check_step_contract`` at full width;
4. trace: for each served arch, device busy share over a few profiled
   engine steps, kernels a step, and each hand kernel's share of it;
5. parity: reduced qwen2-7b, granite-moe-1b-a400m, mamba2-2.7b,
   jamba-v0.1-52b, deepseek-v3-671b, qwen2-vl-7b and whisper-tiny in
   f32 give the same greedy tokens on the card (kernels) and on the CPU
   (plain versions), with slot recycling;
5a. prefill vs decode: f32 at full width, mamba2 4 layers (S 300 across
   two chunks), granite 4 layers and jamba 8 (both at capacity factor
   E/k, so no token drops), deepseek's 3 dense MLA layers (prefill
   expands k and v from the latent and attends through
   ``flash_attention`` with v padded to 192, decoding attends over it through
   ``flash_decode`` at hd 576, vd 512), DeepSeek-V3 under its published
   rules at 3 dense + 1 MoE layers (YaRN, the grouped sigmoid router
   over 256 with 8 experts held, no drops), qwen2-vl's 2 layers (text) and
   whisper's 4 + 4 (decoding over the cross caches filled from
   ``encoder_kv``): prefill's last-token logits
   through ``ssd_scan``, ``flash_attention``, ``moe_expert_ffn`` and
   ``lora_matmul`` (a shared 2-D LoRA; exact launches, every kernel on
   its f32 variant) against teacher-forced decoding within 1e-3
   row-scaled;
5b. DeepSeek-V3 under its published rules (``published_deepseek``, the
   benchmark's deepseek-v3-8l settings) at full width, 3 dense + 1 MoE
   layers, bf16, one loss and LoRA gradients at 16 x 512 tokens under a
   profiler: exact launches (``flash_attention`` 4, all ``mma_sync``;
   ``lora_matmul`` 8; ``moe_expert_ffn`` 1, ``wgmma`` with a fill), no
   slot dropped, the held share of routed slots printed beside 8/256;
   then the loss through the kernels against the plain path (1e-2);
6. train: llama2-7b-proxy unreduced (32 layers, d 4096, 32/32 heads,
   ff 11008, vocab 32000), bf16, rank-32 f32 LoRA; after one untimed
   local step, three federated rounds of 2 clients x 2 local AdamW
   steps of 4 x 1024 tokens through ``make_federated_round_step``
   (fedavg), timed by their median; in each round ``lora_matmul`` must
   have launched 2 x 32 and ``flash_attention`` 32 times per forward,
   and neither in a backward, every ``lora_matmul`` call on the wgmma
   kernel unpadded and every ``flash_attention`` call on its wgmma
   kernel; device busy share over one profiled step;
7. train parity: full-width loss through the kernels vs the plain path
   on the card; reduced llama2-7b-proxy, qwen2-7b, mamba2-2.7b,
   qwen2-vl-7b (with its vision prefix) and whisper-tiny (with audio
   frames) in f32, loss and
   every LoRA gradient on the card (kernels) vs the CPU (plain), and
   3 local steps of ``make_local_train``;
7a. whisper-tiny at full width (4 + 4 layers, d 384), bf16, rank-32
   LoRA on the decoder, 4 x (1500 frames + 448 tokens): three
   ``make_train_step`` steps after a warm-up with exact launches (the
   encoder's 4 non-causal attentions once, the decoder's layers twice:
   remat recomputes them), a profiled step, the kernels vs the plain
   path on the card, and ``build_submodel`` at capacities 1-4 on the
   card and the CPU (the same groups, the encoder carried whole);
8. methods: llama2-7b-proxy unreduced, the spec from
   ``repro_torch.launch.train``'s parser (2 of 20 clients x K=2 local
   steps of 4 x 1024 tokens, rank-32 f32 LoRA, bf16 params), through
   ``sweep_cases`` on the card: FLoRA, DoFIT and C2A one round each,
   ProgFed two stages of one round (capacities 16, 32 from
   ``make_schedule``), then ``aggregate_seeds``; each round's exact
   launches (``lora_matmul`` 2 x depth and ``flash_attention`` depth per
   forward, all on their wgmma kernels unpadded, the rest 0); uplink and
   downlink 67,108,864 B a client at full depth; C2A's B zero after the
   round; ProgFed's initial global LoRA bit-identical before
   ``finalize``; DoFIT's B zero at init and |A_col|^2 equal to the
   singular values, and its SVD init's wall; ms per local step,
   tokens/s and peak memory per method;
9. handoff: one FedSA round (2 of 4 clients; uplink 33,554,432 B a
   client, A only) through ``run_experiment(export_adapters=True)``, the
   personalization's launches (4 clients x K=2 steps) and wall; the
   ``.ckpt`` round trip of ``{"lora": final LoRA}`` on the card (bit-
   exact; size and times); the registry (``global`` bit-equal to the
   final LoRA, ``client/0..3`` differing from it) served at full width
   (8 slots, capacity 1024, 8 requests of 16-512 prompt and 32 generated
   tokens; ``flash_decode`` once per layer per step, all ``tma_mma``,
   no training kernel); ``kv_cache.flash_decode(backend="auto")`` at the
   serve shape: one launch, within the kernel phase's limits of the
   plain version;
10. devft: granite-moe-1b-a400m unreduced (24 layers, d 1024, 16/8
   heads of 64, 32 experts top 8 of width 512, vocab 49155), bf16
   params, rank-32 f32 LoRA, through ``repro_torch.launch.train``'s spec
   resolution and ``run_experiment``: DevFT, 4 rounds in 4 stages
   (capacities 3, 6, 12, 24), 2 of 20 clients x 2 local steps of 4 x
   1024 tokens; exact launch counts (``moe_expert_ffn`` and
   ``flash_attention`` 225, ``lora_matmul`` 450, all three on their
   wgmma kernels, ``moe_expert_ffn`` every call with the fill,
   ``lora_matmul`` and ``moe_expert_ffn`` unpadded, ``flash_decode`` 0),
   per-stage submodel build time, ms per local step, tokens/s and peak
   memory, one profiled local step at capacity 24 with
   ``moe_expert_ffn``'s share, round 0's eval loss
   through the kernels vs the plain versions, and the card's DGLG group
   lists against the CPU port's on the same tensors;
11. devft on mamba2-2.7b unreduced (64 layers, d 2560, d_inner 5120, 80
   heads of 64, N 128, G 1, chunk 256, vocab 50280) through the same
   function with the same settings: capacities 8, 16, 32, 64; exact
   launch counts (``ssd_scan`` 600, every call on its ``mma`` kernel,
   ``lora_matmul`` 1200 on in_proj and out_proj, the other three 0); the
   profiled step at capacity 64 with ``ssd_scan``'s share;
12. devft on jamba-v0.1-52b at full width over one interleave period (8
   of 32 layers, the spec's config cut; 25.6 GB): capacities 1, 2, 4, 8
   over the stacks mamba_mlp / mamba_moe / attn_mlp (1, 1, 1), (1, 1, 1),
   (2, 1, 1), (3, 4, 1); launches per layer by block kind (``ssd_scan``
   70, ``moe_expert_ffn`` 35, ``flash_attention`` 20, ``lora_matmul``
   180); DGLG's groups card vs CPU for every stack a stage cut;
13. devft on deepseek-v3-671b at full width over its 3 dense and 1 MoE
   layers (4 of 61; 29.7 GB): capacities 1, 2, 3, 4 over dense / moe
   (1, 1), (1, 1), (2, 1), (3, 1) (the MoE stack is never cut, so no
   stage copies its 22.5 GB of experts); ``lora_matmul`` 110 on W_q_b
   and W_kv_b, ``moe_expert_ffn`` 20, ``flash_attention`` 55 (MLA's
   attention with v zero-padded to q/k's 192, ``mma_sync``).
14. devft on qwen2-vl-7b at full width and depth (28 layers, 15.2 GB;
   text-only batches, as in the JAX package): capacities 4, 7, 14, 28;
   ``flash_attention`` 265 and ``lora_matmul`` 530; then one
   ``make_train_step`` step with the 256-patch vision prefix (S1280) on
   the run's base params and final LoRA, exact launches, profiled, and
   its loss and gradients through the kernels vs the plain path.
   After the train parity phase, remat: full-width llama2-7b-proxy,
   one ``make_train_step`` step of 4 x 1024 tokens under remat False,
   True and ``dots_with_no_batch_dims_saveable``: ms per step, peak
   memory, exact launches (the recompute launches each kernel again),
   the one-card dry-run's predicted peak, FLOPs and roofline for the
   same step beside them; the loss bit-equal and the LoRA gradients
   within 1e-6 of their norm across the policies.
   After each of the five DevFT phases, its run's ``global`` adapter
   (``registry_from_run(..., personalize=False)``, bit-equal to the
   final LoRA) is served on the run's base params, 4 requests of 16 + 8
   tokens, with the serve phase's launch checks.
15. mesh, after the DevFT phases: the 1x1 host mesh on the card
   (``make_host_mesh``: a world-1 ``nccl`` group, destroyed at the end);
   granite-moe-1b-a400m's DevFT run of phase 10 again through
   ``run_experiment(spec.replace(mesh="host"))`` (params placed as
   DTensors, gathered layer by layer): RoundLog integers equal, floats
   and the final LoRA bit-equal to the ``mesh=None`` run (held within
   1e-2 only if a second ``mesh=None`` run is not bit-equal either), the
   same launches; then one ``make_train_step`` step of 4 x 1024 tokens on
   each MoE path on the mesh, with remat: exact launches (each kernel
   twice a layer), every ``moe_expert_ffn`` shape held by a kernel-phase
   case (``MESH_MOE``: ep's local capacity 2048 is ``MOE_EP``),
   ``gather_sharded`` bit-equal to ``gather``, ``ep`` and ``gather``
   through the kernels against their plain paths on the card (loss
   1e-2; ep's gradients within ``MESH_GRAD_RATIO`` times gather's own
   difference, at most ``MESH_GRAD_TOL`` of their norms), step times and
   peak memory.
16. examples, after the mesh phase: the four ``examples/torch_*.py``
   through their ``main(argv)`` on the card, in f32 as in the JAX
   package. quickstart (the preset: reduced llama2-7b-proxy, 8 layers,
   12 rounds of DevFT at capacities 2, 4, 8): exact launches derived from
   its RoundLogs (``lora_matmul`` and ``flash_attention`` on ``fma_f32``),
   its integer books equal to the same run on the CPU, then ``--rounds
   2`` from a fresh interpreter; stage_anatomy: DBLF error within
   ``EXAMPLE_DBLF_TOL``, the transfer broadcast, and the card's groups
   beside the CPU port's on the same tensors, with W's eigen-gap;
   serve_adapter on every arch (reduced; 16 prompt and 16 generated
   tokens at batch 4, with the adapter and merged): exact launches per
   decode step derived from the config (``flash_decode`` a layer that
   attends over a cache, ``moe_expert_ffn`` a MoE layer, both ``fma``;
   ``lora_matmul`` none: decoding passes no backend, as in JAX), per-token
   ms with and without the adapter, adapter and merged logits within
   ``EXAMPLE_MERGED_TOL`` and the same tokens; the ~100M run at its
   defaults (12 layers d 512, DevFT and FedIT, 30 rounds each): exact
   launches, per-method wall and final loss, the JSON it writes, and
   DevFT's comm and FLOPs ratios (both above 1).

Every phase raises on failure, so the script exits non-zero; it also
exits non-zero, printing no result, without a CUDA card or without the
package beside it. The last lines are the ``kernels`` JSON object, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM published peaks (NVIDIA data sheet) used for the bounds:
#: HBM bytes/s, CUDA-core f32 FLOP/s (the f32 kernels' dot products) and
#: dense bf16 tensor-core FLOP/s. ``main`` reads them from
#: ``repro_torch.kernels.common`` once it has put the package on the path
HBM_BYTES_PER_S = F32_FLOPS = BF16_FLOPS = None
CUDA_ITERS = 30            # timed launches per measurement (median)
TRAIN_ROUNDS = 3           # timed federated rounds after a warm-up (median)
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


def time_cuda(fn, flush: torch.Tensor, iters: int = CUDA_ITERS,
              clean: bool = False) -> float:
    """Median device time (ms) of one ``fn()`` call. Before each timed
    call the L2 cache is flushed and the stream is held busy, so the
    events bracket the call's device work only, with a cold L2 as in the
    serving step (each layer's cache is different memory). The flush
    writes ``flush``, so L2 is left full of dirty lines that the call
    writes back as it reads; ``clean`` flushes by reading it instead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if clean:
            flush.sum()
        else:
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
    for source in build.SOURCES:
        for line in build.build_log(source).splitlines():
            if "Compiling entry function" in line:
                print(f"[device] ptxas {source}: {line.split(chr(39))[1]}")
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):
                print(f"[device] ptxas {source}:   {line.strip()}")
    return name, smi, seconds


#: the flash_decode cases of the ``kernels`` line (qwen2-7b's decode at a
#: long cache) and of the serving phase's own shape
DECODE_PATH = "path C4096 bf16"
DECODE_SERVE = "serve C1024 bf16"
#: the decode shapes of granite-moe-1b-a400m and jamba-v0.1-52b (8 slots,
#: capacity 1024) and of granite's DevFT run served (4 slots, capacity 24)
DECODE_GRANITE = "granite B8 C1024 H16/8 hd64 bf16"
DECODE_JAMBA = "jamba B8 C1024 H32/8 hd128 bf16"
DECODE_DEVFT = "granite devft-serve B4 C24 H16/8 hd64 bf16"
DECODE_JAMBA_DEVFT = "jamba devft-serve B4 C24 H32/8 hd128 bf16"
#: deepseek-v3-671b's absorbed MLA decode: q = [q_abs | q_rope] (hd 512 +
#: 64), one latent kv head [c | k_rope], v = c (vd 512), 128 query heads;
#: served at 8 slots of 1024 and its DevFT run at 4 slots of 24
DECODE_MLA = "deepseek B8 C1024 H128/1 hd576 vd512 bf16"
DECODE_MLA_DEVFT = "deepseek devft-serve B4 C24 H128/1 hd576 vd512 bf16"
#: whisper-tiny's decoder self-attention served at 8 slots of its
#: published context (448), and qwen2-vl-7b's DevFT run served (4 slots of
#: 24; its engine serving is qwen2-7b's shape, ``DECODE_SERVE``)
DECODE_WHISPER = "whisper B8 C448 H6/6 hd64 bf16"
DECODE_VL_DEVFT = "qwen2-vl devft-serve B4 C24 H28/4 hd128 bf16"
#: every flash_decode shape a serving phase launches, bf16: (slots, heads,
#: kv heads, head dim, v head dim, capacity) -> the kernel phase's case
#: that holds it
SERVED_DECODE = {
    (8, 28, 4, 128, 128, 1024): DECODE_SERVE,
    (8, 16, 8, 64, 64, 1024): DECODE_GRANITE,
    (8, 32, 8, 128, 128, 1024): DECODE_JAMBA,
    (4, 16, 8, 64, 64, 24): DECODE_DEVFT,
    (4, 32, 8, 128, 128, 24): DECODE_JAMBA_DEVFT,
    (8, 128, 1, 576, 512, 1024): DECODE_MLA,
    (4, 128, 1, 576, 512, 24): DECODE_MLA_DEVFT,
    (8, 6, 6, 64, 64, 448): DECODE_WHISPER,
    (4, 28, 4, 128, 128, 24): DECODE_VL_DEVFT,
}


def _decode_shape(cfg, n_slots, capacity):
    """(slots, heads, kv heads, hd, vd, capacity) of ``cfg``'s
    ``flash_decode`` calls: MLA attends over its latent (one kv head,
    hd = kv_lora_rank + rope, vd = kv_lora_rank)."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return (n_slots, cfg.n_heads, 1, m.kv_lora_rank + m.qk_rope_head_dim,
                m.kv_lora_rank, capacity)
    return (n_slots, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.hd, capacity)


def _decode_variant(cfg, dtype):
    """The ``flash_decode`` variant ``cfg``'s decode plans: ``tma_mma`` in
    bf16 up to head dim 128, ``fma`` otherwise (f32, and MLA's 576 / 512)."""
    hd, vd = _decode_shape(cfg, 1, 1)[3:5]
    return ("tma_mma" if dtype == torch.bfloat16 and max(hd, vd) <= 128
            else "fma")


def _held_cases(cfg, n_slots, capacity, launches):
    """The kernel-phase cases at the shapes a serving phase launched
    (``launches`` by wrapper); raises where no case holds one."""
    from repro_torch.models.moe import _capacity

    held = []
    if launches["flash_decode_bhrd"]:
        shape = _decode_shape(cfg, n_slots, capacity)
        check(shape in SERVED_DECODE, f"flash_decode at (B, H, Hkv, hd, vd, "
              f"C) {shape}: no kernel-phase case holds this shape")
        held.append(SERVED_DECODE[shape])
    if launches["moe_expert_ffn_ecd"]:
        m = cfg.moe
        shape = (m.n_experts, _capacity(cfg, n_slots), cfg.d_model,
                 m.d_ff_expert)
        check(shape in SERVED_MOE, f"moe_expert_ffn at (E, C, d, ff) "
              f"{shape}: no kernel-phase case holds this shape")
        held.append(SERVED_MOE[shape])
    return held


def _kernels_per_call(fn, n: int = 5) -> float:
    """CUDA kernels one ``fn()`` call launches, from torch.profiler's
    host-side launch records over ``n`` calls (nan if it records none).
    Its device-side kernel records are no count: over a short window they
    drop the first kernel or carry earlier ones over (4 or 7 seen for 5
    one-kernel calls on the H100); the launch records do not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    launches = [e for e in prof.events() if e.device_type != DeviceType.CUDA
                and "LaunchKernel" in e.name]
    return len(launches) / n if launches else float("nan")


def kernel_phase(flash_decode_bhrd, flash_decode_ref, seed: int = 0):
    """flash_decode vs its plain version at the serving shapes."""
    from repro_torch.kernels.flash_decode import plan, run_plan, sm_count

    dev = "cuda"
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1)))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = [  # name, B, H, Hkv, hd, vd, C, q dtype, cache dtype
        (DECODE_PATH, 8, 28, 4, 128, 128, 4096,
         torch.bfloat16, torch.bfloat16),
        ("path C4096 f32-q bf16-cache", 8, 28, 4, 128, 128, 4096,
         torch.float32, torch.bfloat16),
        ("path C4096 f32", 8, 28, 4, 128, 128, 4096,
         torch.float32, torch.float32),
        ("mla-reduced f32", 4, 4, 1, 48, 32, 64,
         torch.float32, torch.float32),
        ("mla-reduced bf16", 4, 4, 1, 48, 32, 64,
         torch.bfloat16, torch.bfloat16),
        # rows at or past valid hold NaN: they must add nothing
        ("path C4096 bf16 NaN past valid", 8, 28, 4, 128, 128, 4096,
         torch.bfloat16, torch.bfloat16),
        # minicpm-2b's head dim; 16 query heads a kv head with a cache
        # that is no whole number of tiles
        ("minicpm hd64 C2048 bf16", 8, 36, 36, 64, 64, 2048,
         torch.bfloat16, torch.bfloat16),
        ("rep16 C1000 bf16", 4, 32, 2, 128, 128, 1000,
         torch.bfloat16, torch.bfloat16),
    ] + [(case, b, h, hkv, hd, vd, cap, torch.bfloat16, torch.bfloat16)
         for (b, h, hkv, hd, vd, cap), case in SERVED_DECODE.items()] + [
        (case, b, h, hkv, hd, vd, cap, torch.float32, torch.float32)
        for (b, h, hkv, hd, vd, cap), case in EXAMPLE_DECODE.items()]
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
        p = plan(b, h, hkv, cap, hd, vd, qdt, kvdt, sm_count(q.device))
        check(p.variant == ("tma_mma" if qdt == kvdt == torch.bfloat16
                            and max(hd, vd) <= 128 else "fma"),
              f"{name}: plan picked {p.variant}")

        extra = ""
        if "NaN" in name:
            # the kernel on the cache with NaN rows past valid, bit for bit
            # against the kernel on a copy with zeros there
            dead = (torch.arange(cap, device=dev)[None, :]
                    >= valid[:, None])[:, :, None, None]   # (B, C, 1, 1)
            k_nan, v_nan = k.masked_fill(dead, float("nan")), \
                v.masked_fill(dead, float("nan"))
            k, v = k.masked_fill(dead, 0.0), v.masked_fill(dead, 0.0)
            out_nan = flash_decode_bhrd(q, k_nan, v_nan, kv_valid_len=valid)
            del k_nan, v_nan
        out = flash_decode_bhrd(q, k, v, kv_valid_len=valid)
        want = flash_decode_ref(q, k, v, kv_valid_len=valid)
        torch.cuda.synchronize()
        if "NaN" in name:
            check(torch.equal(out_nan, out),
                  f"{name}: NaN rows past valid changed the output")
            extra = " | NaN rows past valid: output bit-equal to zeros there"
        if name in (DECODE_GRANITE, DECODE_JAMBA, DECODE_DEVFT,
                    DECODE_JAMBA_DEVFT, DECODE_MLA, DECODE_MLA_DEVFT,
                    DECODE_WHISPER, DECODE_VL_DEVFT):
            again = flash_decode_bhrd(q, k, v, kv_valid_len=valid)
            torch.cuda.synchronize()
            check(torch.equal(again, out), f"{name}: two calls differ")
            extra = " | two calls bit-equal"
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
        peak = BF16_FLOPS if qdt == kvdt == torch.bfloat16 else F32_FLOPS
        bound_ms, bound_by = _bound(bytes_moved, flops, peak)

        call = lambda: flash_decode_bhrd(q, k, v,  # noqa: E731
                                         kv_valid_len=valid)
        ms = time_cuda(call, flush)
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
            lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True,
                         scale=hd ** -0.5), flush)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, variant=p.variant)
        if name in (DECODE_PATH, DECODE_SERVE, DECODE_MLA):
            # the first design (fma) on the same inputs
            scale = hd ** -0.5
            old = plan(b, h, hkv, cap, hd, vd, qdt, kvdt, sm_count(q.device),
                       variant="fma")
            old_out = run_plan(old, q, k, v, valid, scale)
            torch.cuda.synchronize()
            old_err, old_row_err = _row_scaled(old_out[nonempty],
                                               want[nonempty])
            check(old_err <= tol and old_row_err <= row_tol,
                  f"{name} fma: errors {old_err}, {old_row_err} > "
                  f"{tol}, {row_tol}")
            was = lambda: run_plan(old, q, k, v, valid, scale)  # noqa: E731
            lib = lambda: sdpa(qs, ks, vs, attn_mask=mask,  # noqa: E731
                               enable_gqa=True, scale=hd ** -0.5)
            was_ms = time_cuda(was, flush)
            # the same three after a flush that leaves L2 clean: without
            # the write-back of ~50 MB of dirty lines the dirty flush adds
            clean = {what: time_cuda(fn, flush, clean=True)
                     for what, fn in (("kernel", call), ("fma", was),
                                      ("sdpa", lib))}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CUDA_ITERS):
                call()
            host_us = (time.perf_counter() - t0) / CUDA_ITERS * 1e6
            torch.cuda.synchronize()
            per_call = _kernels_per_call(call)
            rows[name].update(was_ms=was_ms, host_us=host_us,
                              kernels_per_call=per_call,
                              clean_l2_ms=clean["kernel"],
                              clean_l2_was_ms=clean["fma"],
                              clean_l2_library_ms=clean["sdpa"])
            extra += (f" | fma (was) {was_ms * 1e3:.1f} us (row-scaled "
                     f"{old_row_err:.3g}); clean L2: kernel "
                     f"{clean['kernel'] * 1e3:.1f} us "
                     f"({100 * bound_ms / clean['kernel']:.1f}% of bound), "
                     f"fma {clean['fma'] * 1e3:.1f}, sdpa "
                     f"{clean['sdpa'] * 1e3:.1f}; host {host_us:.1f} us per "
                     f"call; {per_call:g} CUDA kernels per call")
        print(f"[kernel] flash_decode {name}: {p.variant} (chunk {p.chunk}, "
              f"grid {p.grid}, {p.stages} stages, {p.smem} B shared); "
              f"B={b} H={h}/{hkv} hd={hd} "
              f"vd={vd} C={cap} valid={valid_np.tolist()} err={err:.3g} "
              f"(tol {tol}) row-scaled {row_err:.3g} (tol {row_tol:.3g}) "
              f"| kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}; "
              f"{bytes_moved / 1e6:.2f} MB in "
              f"{bytes_moved / HBM_BYTES_PER_S * 1e6:.2f} us, "
              f"{flops / 1e9:.3f} GFLOP in "
              f"{flops / peak * 1e6:.2f} us; "
              f"{100 * bound_ms / ms:.1f}% of bound){extra}")
    del flush
    return rows


def _row_scaled(got, want):
    """(max abs error, max over rows of max|got - want| / max|want|)."""
    diff = (got.float() - want.float()).abs()
    size = want.float().abs().amax(-1)
    return float(diff.max()), float((diff.amax(-1) / size).max())


def _bound(bytes_moved, flops, peak_flops):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


#: lora_matmul limits on the row-scaled error. f32: 1e-5, summation
#: order only (K up to 4096 products in f32). bf16: 2**-6, since the
#: kernel rounds x@A to bf16 before the rank product, as the TPU kernel
#: does (lora_matmul.py:89), and the plain version keeps it f32; that and
#: the output's own rounding stay within two bf16 ulps of the row's size.
LORA_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
#: lora_matmul at the llama path shape against an f64 oracle of the same
#: function (x@A rounded to bf16, everything else exact), so the error is
#: the kernel's own: the output's rounding (at most 2**-8 of a row's
#: largest |output|) and the x@A elements whose f32 and f64 sums round to
#: neighbouring bf16 values (up to 5.1e-3 in all; NVIDIA H100 80GB HBM3).
LORA_ORACLE_TOL = 2.0 ** -7
#: the lora_matmul case of the ``kernels`` line and of the f64 oracle
LORA_PATH = "path M4096 K4096 N4096 r32 bf16"


def lora_phase(lora_matmul_fused, lora_matmul_ref, seed: int = 0):
    """lora_matmul vs its plain version; the path shape is one W_q/W_v
    projection of the training step (4 x 1024 tokens, d 4096, r 32). Per
    case: the plan's variant and padding, the pre-pass's time beside the
    whole call's, and the host time of one call (the TMA maps are
    encoded on the host)."""
    import dataclasses

    from repro_torch.kernels.lora_matmul import (pad_operands, plan, prepass,
                                                 run_plan)

    dev = "cuda"
    rng = np.random.default_rng(np.random.SeedSequence((seed, 4)))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16
    cases = [  # name, x shape, N, r, dtype
        (LORA_PATH, (4, 1024, 4096), 4096, 32, bf16),
        ("path M4096 K4096 N4096 r32 f32", (4, 1024, 4096), 4096, 32,
         torch.float32),
        # ranks above 64, which the kernel before the pre-pass refused
        ("path M4096 K4096 N4096 r128 bf16", (4, 1024, 4096), 4096, 128,
         bf16),
        ("path M4096 K4096 N4096 r65 bf16", (4, 1024, 4096), 4096, 65, bf16),
        ("ragged M1000 K1000 N1000 r2 bf16", (1000, 1000), 1000, 2, bf16),
        ("ragged M333 K1001 N777 r8 bf16", (333, 1001), 777, 8, bf16),
        ("ragged M333 K1001 N777 r96 bf16", (333, 1001), 777, 96, bf16),
        ("ragged M1000 K1000 N1000 r32 bf16", (1000, 1000), 1000, 32, bf16),
        ("ragged M333 K1001 N777 r8 f32", (333, 1001), 777, 8,
         torch.float32),
        ("lead B2 S77 K512 N640 r16 bf16", (2, 77, 512), 640, 16, bf16),
        # granite-moe-1b-a400m's W_q and W_v on the DevFT path
        ("granite M4096 K1024 N1024 r32 bf16", (4, 1024, 1024), 1024, 32,
         bf16),
        ("granite M4096 K1024 N512 r32 bf16", (4, 1024, 1024), 512, 32,
         bf16),
        # mamba2-2.7b's in_proj and out_proj on the DevFT path
        ("mamba M4096 K2560 N10576 r32 bf16", (4, 1024, 2560), 10576, 32,
         bf16),
        ("mamba M4096 K5120 N2560 r32 bf16", (4, 1024, 5120), 2560, 32,
         bf16),
        # jamba-v0.1-52b's Mamba in_proj and out_proj and its attention
        # W_v (W_q is the path shape) on the DevFT path
        ("jamba in_proj M4096 K4096 N16544 r32 bf16", (4, 1024, 4096), 16544,
         32, bf16),
        ("jamba out_proj M4096 K8192 N4096 r32 bf16", (4, 1024, 8192), 4096,
         32, bf16),
        ("jamba wv M4096 K4096 N1024 r32 bf16", (4, 1024, 4096), 1024, 32,
         bf16),
        # deepseek-v3-671b's MLA up-projections W_q_b and W_kv_b
        ("deepseek wq_b M4096 K1536 N24576 r32 bf16", (4, 1024, 1536), 24576,
         32, bf16),
        ("deepseek wkv_b M4096 K512 N32768 r32 bf16", (4, 1024, 512), 32768,
         32, bf16),
        # qwen2-vl-7b's W_q and W_v (its bias added after the kernel) on
        # the DevFT path (4 x 1024 text tokens) and with the 256-patch
        # vision prefix (4 x 1280)
        ("qwen2-vl wq M4096 K3584 N3584 r32 bf16", (4, 1024, 3584), 3584,
         32, bf16),
        ("qwen2-vl wv M4096 K3584 N512 r32 bf16", (4, 1024, 3584), 512, 32,
         bf16),
        ("qwen2-vl prefix wq M5120 K3584 N3584 r32 bf16", (4, 1280, 3584),
         3584, 32, bf16),
        ("qwen2-vl prefix wv M5120 K3584 N512 r32 bf16", (4, 1280, 3584),
         512, 32, bf16),
        # whisper-tiny's decoder W_q and W_v (MHA: one shape), 4 x 448
        ("whisper wq/wv M1792 K384 N384 r32 bf16", (4, 448, 384), 384, 32,
         bf16),
    ] + [(case, (b, sq, k), n, r, torch.float32)
         for (b, sq, k, n, r), case in EXAMPLE_LORA.items()]
    rows = {}
    for name, xs, n, r, dt in cases:
        k = xs[-1]

        def rand(*shape, std=1.0):
            a = rng.standard_normal(shape, dtype=np.float32) * std
            return torch.from_numpy(a).to(dev).to(dt)
        x = rand(*xs)
        w = rand(k, n, std=k ** -0.5)
        a = rand(k, r, std=k ** -0.5)
        b = rand(r, n, std=r ** -0.5)
        out = lora_matmul_fused(x, w, a, b, scaling=2.0)
        want = lora_matmul_ref(x, w, a, b, scaling=2.0)
        torch.cuda.synchronize()
        check(out.dtype == want.dtype and out.shape == want.shape,
              f"lora {name}: {out.dtype}{tuple(out.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        err, row_err = _row_scaled(out, want)
        check(row_err <= LORA_ROW_TOL[dt],
              f"lora {name}: row-scaled error {row_err} > {LORA_ROW_TOL[dt]}")
        m = x.numel() // k
        x2 = x.reshape(m, k)
        p = plan(m, k, n, r, dt)
        check(p.variant == ("wgmma" if dt == bf16 else "fma_f32"),
              f"lora {name}: variant {p.variant}")
        on_path = name == LORA_PATH or name.startswith(
            ("granite", "mamba", "jamba", "deepseek", "qwen2-vl", "whisper",
             "quickstart", "100M"))
        check(not (on_path and p.padded),
              f"lora {name}: a training path's shape padded ({p})")
        if name == LORA_PATH:
            xa = (x2.double() @ a.double()).to(dt).double()
            oracle = x2.double() @ w.double() + 2.0 * (xa @ b.double())
            _, oracle_err = _row_scaled(out.reshape(m, n), oracle)
            del xa, oracle
            check(oracle_err <= LORA_ORACLE_TOL,
                  f"lora {name}: row-scaled error vs the f64 oracle "
                  f"{oracle_err} > {LORA_ORACLE_TOL}")
            print(f"[kernel] lora_matmul {name}: row-scaled error vs the "
                  f"f64 oracle (x@A rounded to bf16) {oracle_err:.3g} (tol "
                  f"{LORA_ORACLE_TOL:.3g})")
        esz = x.element_size()
        bytes_moved = esz * (m * k + k * n + k * r + r * n + m * n)
        flops = 2 * m * n * k + 2 * m * r * (k + n)
        bound_ms, bound_by = _bound(
            bytes_moved, flops,
            BF16_FLOPS if dt == bf16 else F32_FLOPS)
        ms = time_cuda(lambda: lora_matmul_fused(x, w, a, b, scaling=2.0),
                       flush)
        xp, _, ap, _ = pad_operands(p, x2, w, a, b)
        prepass_ms = time_cuda(lambda: prepass(p, xp, ap), flush)
        if name == LORA_PATH:
            # yardstick of the pre-pass alone: cuBLAS's x @ a, the same
            # reads of x (and no rounding)
            xa_ms = time_cuda(lambda: torch.matmul(x2, a), flush)
            print(f"[kernel] lora_matmul {name}: pre-pass "
                  f"{prepass_ms * 1e3:.1f} us, x @ a alone (matmul) "
                  f"{xa_ms * 1e3:.1f} us, reading x ({m * k * esz / 1e6:.1f}"
                  f" MB) at {m * k * esz / prepass_ms / 1e9:.2f} TB/s")
        other = ""
        if on_path:
            # the tile width the plan did not pick, on the same inputs
            bn = 384 - p.block_n
            alt = dataclasses.replace(
                p, block_n=bn, grid=(-(-m // 128) * -(-p.n_pad // bn), 1))
            alt_ms = time_cuda(lambda: run_plan(alt, x2, w, a, b, 2.0),
                               flush)
            other = f", block_n {bn} {alt_ms * 1e3:.1f} us"
        plain_ms = time_cuda(
            lambda: lora_matmul_ref(x, w, a, b, scaling=2.0), flush)
        # yardstick only: the frozen product x @ w alone (no single
        # PyTorch call computes the fused function)
        library_ms = time_cuda(lambda: torch.matmul(x, w), flush)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CUDA_ITERS):
            lora_matmul_fused(x, w, a, b, scaling=2.0)
        host_us = (time.perf_counter() - t0) / CUDA_ITERS * 1e6
        torch.cuda.synchronize()
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, variant=p.variant,
                          prepass_ms=prepass_ms, padded=p.padded)
        print(f"[kernel] lora_matmul {name}: {p.variant}, block_n "
              f"{p.block_n}, {'padded' if p.padded else 'not padded'}; "
              f"err={err:.3g} row-scaled {row_err:.3g} (tol "
              f"{LORA_ROW_TOL[dt]:.3g}) | call {ms * 1e3:.1f} us (pre-pass "
              f"{prepass_ms * 1e3:.1f} us{other}), plain "
              f"{plain_ms * 1e3:.1f} us, "
              f"x@w alone (matmul) {library_ms * 1e3:.1f} us, bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}; {flops / 1e9:.2f} "
              f"GFLOP, {bytes_moved / 1e6:.2f} MB; {100 * bound_ms / ms:.1f}"
              f"% of bound, {flops / ms / 1e9:.1f} TFLOP/s); host "
              f"{host_us:.1f} us per call")
    del flush
    return rows


def _check_lora_variants(lora_matmul_fused, tag):
    """Every lora_matmul call since the last ``reset_counts`` ran the
    wgmma kernel on unpadded operands."""
    fn = lora_matmul_fused
    check(dict(fn.variants) == {"wgmma": fn.launches} and fn.padded == 0,
          f"{tag}: lora_matmul variants {dict(fn.variants)}, padded "
          f"{fn.padded} of {fn.launches} calls")
    print(f"[{tag}] lora_matmul: all {fn.launches} calls on the wgmma "
          f"kernel, none padded")


def _bf16_ulps(got, want):
    """Distance in bf16 steps between two bf16 tensors, elementwise (the
    bit patterns in sign-magnitude order, so +0 and -0 are one point)."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(got) - key(want)).abs()


#: the input gradient against the plain f32 one (``ops``'s plain route):
#: the share of dx's bf16 elements that must be bit-equal; the rest may
#: lie one bf16 step away where the sum does not cancel (|dx| at least
#: 2**-8 of its row's largest), and nowhere more than a step of the row's
#: largest, 2**-7 of it at most (the f32 sums differ in order only, and
#: where they cancel that is more than a step of the tiny result); and the
#: limit on g_xa's row-scaled error and on dA's over its largest |value|
#: (f32 sums in another order, depth up to N = 32768 and M = 8192)
LORA_BWD_EQUAL = 0.99
LORA_BWD_F32_TOL = 1e-5
#: the scaling of the backward cases: not a power of two, so that s * g
#: and the products of g_xa are rounded as in the cells
LORA_BWD_SCALING = 0.7
#: the backward cases on the benchmark's cells (M = 16 x 512 tokens)
LORA_BWD_CELLS = ("jamba in_proj M8192 K4096 N16544 r32",
                  "jamba out_proj M8192 K8192 N4096 r32",
                  "granite wq M8192 K1024 N1024 r32",
                  "granite wv M8192 K1024 N512 r32")


def _plain_dx(g2, w, a, b, s):
    """dx and g_xa as ``ops``'s plain route computes them (f32 products of
    f32 copies, one rounding)."""
    g = g2.float()
    g_xa = (g * s) @ b.float().t()
    return (g @ w.float().t() + g_xa @ a.float().t()).to(g2.dtype), g_xa


def lora_bwd_phase(seed: int = 0):
    """The input gradient's kernel (``lora_matmul_bwd``: pre-pass + main
    pass) against the plain f32 products at the cells' shapes, the other
    path shapes and ragged ones, B random and s = 0.7: dx bit-equal on at
    least ``LORA_BWD_EQUAL`` of its elements and within one bf16 step on
    the rest; g_xa and dA within f32 summation order. On the cells'
    shapes: the call's time, the pre-pass's, the plain f32 dx's and
    cuBLAS's bf16 ``g @ w.t()`` (yardstick), beside
    the bound (2·M·N·K + 2·M·r·(N + K) operations at the bf16 peak)."""
    from repro_torch.kernels.lora_matmul import (lora_matmul_bwd,
                                                 pad_bwd_operands, plan_bwd,
                                                 prepass_bwd)

    dev, bf16, s = "cuda", torch.bfloat16, LORA_BWD_SCALING
    rng = np.random.default_rng(np.random.SeedSequence((seed, 32)))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = [  # name, M, K, N, r
        (LORA_BWD_CELLS[0], 8192, 4096, 16544, 32),
        (LORA_BWD_CELLS[1], 8192, 8192, 4096, 32),
        (LORA_BWD_CELLS[2], 8192, 1024, 1024, 32),
        (LORA_BWD_CELLS[3], 8192, 1024, 512, 32),
        ("path M4096 K4096 N4096 r32", 4096, 4096, 4096, 32),
        ("mamba in_proj M4096 K2560 N10576 r32", 4096, 2560, 10576, 32),
        ("mamba out_proj M4096 K5120 N2560 r32", 4096, 5120, 2560, 32),
        ("deepseek wq_b M4096 K1536 N24576 r32", 4096, 1536, 24576, 32),
        ("deepseek wkv_b M4096 K512 N32768 r32", 4096, 512, 32768, 32),
        ("qwen2-vl wq M4096 K3584 N3584 r32", 4096, 3584, 3584, 32),
        ("whisper wq/wv M1792 K384 N384 r32", 1792, 384, 384, 32),
        ("ragged M333 K200 N136 r8", 333, 200, 136, 8),
        ("ragged M333 K1001 N777 r96", 333, 1001, 777, 96),
        ("rank M4096 K4096 N4096 r128", 4096, 4096, 4096, 128),
        ("rank M1000 K1000 N1000 r2", 1000, 1000, 1000, 2),
    ]
    rows = {}
    for name, m, k, n, r in cases:
        def rand(*shape, std=1.0):
            t = rng.standard_normal(shape, dtype=np.float32) * std
            return torch.from_numpy(t).to(dev).to(bf16)
        g = rand(m, n, std=1e-3)
        w = rand(k, n, std=k ** -0.5)
        a = rand(k, r, std=k ** -0.5)
        b = rand(r, n, std=r ** -0.5)
        x2 = rand(m, k)
        p = plan_bwd(m, k, n, r, bf16)
        before = lora_matmul_bwd.launches
        dx, g_xa = lora_matmul_bwd(g, w, a, b, scaling=s)
        want, want_xa = _plain_dx(g, w, a, b, s)
        torch.cuda.synchronize()
        check(lora_matmul_bwd.launches == before + 1,
              f"lora bwd {name}: launches {lora_matmul_bwd.launches}")
        check(dx.dtype == bf16 and dx.shape == (m, k),
              f"lora bwd {name}: dx {dx.dtype}{tuple(dx.shape)}")
        ulps = _bf16_ulps(dx, want)
        equal = float((ulps == 0).float().mean())
        size = want.float().abs().amax(-1, keepdim=True)
        whole = want.float().abs() >= size * 2.0 ** -8
        whole_ulps = int(ulps[whole].max())
        _, dx_err = _row_scaled(dx, want)
        _, xa_err = _row_scaled(g_xa, want_xa)
        x32 = x2.float()
        # dA over its largest |value| (a row of dA has only r elements)
        da, da_want = x32.t() @ g_xa, x32.t() @ want_xa
        da_err = float((da - da_want).abs().max() / da_want.abs().max())
        del da, da_want
        # g_xa rounded once to bf16 (what the split avoids): the share of
        # dx it would leave bit-equal
        once = (g.float() @ w.float().t()
                + g_xa.to(bf16).float() @ a.float().t()).to(bf16)
        equal_once = float((_bf16_ulps(once, want) == 0).float().mean())
        del once, x32, want_xa, size, whole
        row = dict(variant=p.variant, padded=p.padded, block_n=p.block_n,
                   equal=equal, max_ulps=whole_ulps, dx_err=dx_err,
                   g_xa_err=xa_err, da_err=da_err,
                   equal_g_xa_once=equal_once)
        line = (f"[kernel] lora_matmul_bwd {name}: {p.variant}, block_n "
                f"{p.block_n}, {'padded' if p.padded else 'not padded'}; dx "
                f"bit-equal {100 * equal:.3f}% (tol {100 * LORA_BWD_EQUAL:g}"
                f"%), max {whole_ulps} bf16 step where |dx| >= 2^-8 of its "
                f"row's largest, row-scaled {dx_err:.3g} (tol 2^-7); g_xa "
                f"row-scaled {xa_err:.3g}, dA scaled {da_err:.3g} (tol "
                f"{LORA_BWD_F32_TOL:g}); with g_xa rounded once to bf16 "
                f"{100 * equal_once:.2f}% bit-equal")
        print(line)
        check(equal >= LORA_BWD_EQUAL and whole_ulps <= 1
              and dx_err <= 2.0 ** -7,
              f"lora bwd {name}: {equal:.5f} of dx bit-equal, "
              f"{whole_ulps} bf16 steps at most where the sum does not "
              f"cancel, row-scaled {dx_err}")
        check(xa_err <= LORA_BWD_F32_TOL and da_err <= LORA_BWD_F32_TOL,
              f"lora bwd {name}: g_xa row-scaled {xa_err}, dA {da_err}")
        on_path = not name.startswith(("ragged", "rank"))
        check(p.variant == "wgmma" and not (on_path and p.padded),
              f"lora bwd {name}: plan {p}")
        line = f"[kernel] lora_matmul_bwd {name}: timed"
        if name in LORA_BWD_CELLS:
            flops = 2 * m * n * k + 2 * m * r * (n + k)
            bytes_moved = 2 * (m * n + k * n + k * r + r * n + m * k) \
                + 4 * m * r
            bound_ms, bound_by = _bound(bytes_moved, flops, BF16_FLOPS)
            ms = time_cuda(lambda: lora_matmul_bwd(g, w, a, b, scaling=s),
                           flush)
            gp, _, _, bp = pad_bwd_operands(p, g, w, a, b)
            prepass_ms = time_cuda(lambda: prepass_bwd(p, gp, bp, s), flush)
            plain_ms = time_cuda(lambda: _plain_dx(g, w, a, b, s), flush)
            library_ms = time_cuda(lambda: torch.matmul(g, w.t()), flush)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CUDA_ITERS):
                lora_matmul_bwd(g, w, a, b, scaling=s)
            host_us = (time.perf_counter() - t0) / CUDA_ITERS * 1e6
            torch.cuda.synchronize()
            row.update(ms=ms, prepass_ms=prepass_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            line += (f" | call {ms * 1e3:.1f} us (pre-pass "
                     f"{prepass_ms * 1e3:.1f} us), plain f32 dx "
                     f"{plain_ms * 1e3:.1f} us, g @ w.t() alone (matmul, "
                     f"bf16) {library_ms * 1e3:.1f} us, bound "
                     f"{bound_ms * 1e3:.2f} us ({bound_by}; "
                     f"{flops / 1e9:.2f} GFLOP; {100 * bound_ms / ms:.1f}% "
                     f"of bound, {flops / ms / 1e9:.1f} TFLOP/s); host "
                     f"{host_us:.1f} us per call")
            print(line)
        rows[name] = row
        del g, w, a, b, x2, dx, g_xa, want
    del flush
    return rows


def _check_lora_bwd(tag, want):
    """Every lora_matmul backward since the last ``reset_counts`` took the
    input-gradient kernel (``want`` calls: one a training forward), on
    the wgmma variant, unpadded; none ran the plain products."""
    from repro_torch.kernels.lora_matmul import lora_matmul_bwd as fn
    check(fn.launches == want and fn.plain == 0
          and dict(fn.variants) == {"wgmma": want} and fn.padded == 0,
          f"{tag}: lora_matmul_bwd launches {fn.launches} (want {want}), "
          f"plain {fn.plain}, variants {dict(fn.variants)}, padded "
          f"{fn.padded}")
    print(f"[{tag}] lora_matmul_bwd: all {want} backward calls (one a "
          f"training forward's lora_matmul) on the wgmma kernel, none "
          f"padded, none plain")


#: flash_attention limits on the row-scaled error. f32: 1e-4, as the
#: decode kernel (summation order of the online softmax only). bf16:
#: 2**-5: the kernel rounds the probabilities to bf16 for the PV product
#: on the tensor cores and the plain version keeps them f32; with the
#: output's own rounding that is a few bf16 ulps (2**-8 each) of the
#: row's largest output at most.
FLASH_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}


def _live_pairs(s, causal, window):
    """(query, key) pairs the mask keeps, per head."""
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    return int(keep.sum())


#: the flash_attention cases of the ``kernels`` line (llama2-7b-proxy's
#: attention) and of granite-moe-1b-a400m's DevFT path
FLASH_PATH = "path B4 S1024 H32 D128 causal bf16"
FLASH_GRANITE = "granite B4 S1024 H16/8 D64 causal bf16"
#: jamba-v0.1-52b's attention layer on its DevFT path
FLASH_JAMBA = "jamba B4 S1024 H32/8 D128 causal bf16"
#: whisper-tiny's encoder (non-causal over 1500 frames: 11 tiles of 128
#: and a ragged 92) and decoder self-attention (its 448-token context),
#: and qwen2-vl-7b's layer on the DevFT path and with the 256-patch prefix
FLASH_WHISPER_ENC = "whisper enc B4 S1500 H6 D64 full bf16"
FLASH_WHISPER_DEC = "whisper dec B4 S448 H6 D64 causal bf16"
FLASH_VL = "qwen2-vl B4 S1024 H28/4 D128 causal bf16"
FLASH_VL_PREFIX = "qwen2-vl B4 S1280 H28/4 D128 causal bf16"
#: MLA's training attention in the deepseek-v3-8l.devft cell (16 x 512
#: tokens, 128 heads, q/k head dim 192): ``attend`` zero-pads v's 128 to
#: 192, so the kernel runs ``mma_sync`` and the padded outputs are zero
FLASH_MLA = "deepseek-v3 MLA B16 S512 H128 D192 v128 causal bf16"


def _denominators(q, k, v, scale):
    """The causal attention of bf16 q, k, v in f32 with the probabilities
    rounded to bf16 for the PV product, as the kernels do, divided by the
    row sum of the rounded probabilities (the first design) and of the
    unrounded ones (the TPU kernel, flash_attention.py:115-117); both
    (B, S, H, D) in f32, not rounded."""
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = sc.shape[-1]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~keep, float("-inf"))
    p = torch.exp(sc - sc.amax(-1, True))
    del sc
    pb = p.to(torch.bfloat16).float()
    o = torch.einsum("bhqk,bkhd->bhqd", pb, v.float())
    old = (o / pb.sum(-1, True)).transpose(1, 2)
    new = (o / p.sum(-1, True)).transpose(1, 2)
    return old, new


def _check_flash_variant(flash_attention_bshd, tag, variant="wgmma"):
    """Every flash_attention call since the last ``reset_counts`` ran the
    ``variant`` kernel (``mma_sync`` for MLA's head dim of 192)."""
    fn = flash_attention_bshd
    check(set(fn.variants) <= {variant}
          and fn.variants[variant] == fn.launches,
          f"{tag}: flash_attention variants {dict(fn.variants)} of "
          f"{fn.launches} calls")
    print(f"[{tag}] flash_attention: all {fn.launches} calls on the "
          f"{variant} kernel")


def attention_phase(flash_attention_bshd, attention_bshd_ref,
                    seed: int = 0, only=None):
    """flash_attention vs its plain version; the path shapes are one layer
    of the training step of llama2-7b-proxy and of granite-moe-1b-a400m
    (4 x 1024 tokens). Per case: the variant the call ran. At the path
    shapes also the first design (``mma_sync``) on the same inputs,
    TFLOP/s, the share of the bound and the host time of one call (four
    TMA maps are encoded on the host). ``only``: the names of the cases
    to run (all where None)."""
    from repro_torch.kernels.flash_attention import (library_smem_bytes,
                                                     plan, reset_counts,
                                                     run_plan)

    dev = "cuda"
    rng = np.random.default_rng(np.random.SeedSequence((seed, 5)))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, S, H, Hkv, D, causal, window, dtype, inputs
        # the non-causal branch first: no other path runs it
        (FLASH_WHISPER_ENC, 4, 1500, 6, 6, 64, False, None, bf16, "randn"),
        (FLASH_PATH, 4, 1024, 32, 32, 128, True, None, bf16, "randn"),
        ("path B4 S1024 H32 D128 causal f32", 4, 1024, 32, 32, 128, True,
         None, f32, "randn"),
        ("gqa 28/4 S1024 causal bf16", 2, 1024, 28, 4, 128, True, None,
         bf16, "randn"),
        ("window 256 S1024 causal bf16", 2, 1024, 8, 8, 128, True, 256,
         bf16, "randn"),
        ("window 64 S1024 causal bf16", 2, 1024, 8, 8, 128, True, 64, bf16,
         "randn"),
        ("ragged S1000 causal bf16", 2, 1000, 8, 2, 128, True, None, bf16,
         "randn"),
        ("ragged S100 causal bf16", 2, 100, 8, 2, 128, True, None, bf16,
         "randn"),
        ("full S512 bf16", 2, 512, 8, 8, 128, False, None, bf16, "randn"),
        ("ragged S300 gqa causal f32", 2, 300, 8, 2, 64, True, None, f32,
         "randn"),
        (FLASH_GRANITE, 4, 1024, 16, 8, 64, True, None, bf16, "randn"),
        (FLASH_JAMBA, 4, 1024, 32, 8, 128, True, None, bf16, "randn"),
        (FLASH_WHISPER_DEC, 4, 448, 6, 6, 64, True, None, bf16, "randn"),
        (FLASH_VL, 4, 1024, 28, 4, 128, True, None, bf16, "randn"),
        (FLASH_VL_PREFIX, 4, 1280, 28, 4, 128, True, None, bf16, "randn"),
        ("ragged S1500 full f32", 2, 1500, 4, 4, 64, False, None, f32,
         "randn"),
        ("ragged S1000 window 300 D64 bf16", 2, 1000, 4, 2, 64, True, 300,
         bf16, "randn"),
        # q, k, v as strided views of one (B, S, 3H, D) tensor
        ("fused qkv S700 H8 D128 causal bf16", 2, 700, 8, 8, 128, True,
         None, bf16, "qkv"),
        ("fused qkv S700 H8 D64 causal bf16", 2, 700, 8, 8, 64, True, None,
         bf16, "qkv"),
        # V one-hot per key: the output is the probability matrix, so a
        # wrong layout of P in the PV product's A registers shows
        ("identity V S128 D128 causal bf16", 2, 128, 4, 4, 128, True, None,
         bf16, "eye"),
        ("identity V S120 D128 full bf16", 2, 120, 4, 4, 128, False, None,
         bf16, "eye"),
        ("identity V S64 D64 causal bf16", 2, 64, 4, 4, 64, True, None,
         bf16, "eye"),
        # 16 blocks: fewer than the card's SMs
        ("grid B1 S1024 H2 D128 causal bf16", 1, 1024, 2, 2, 128, True,
         None, bf16, "randn"),
        # v's last 64 columns zero, as ``attend`` pads MLA's v
        (FLASH_MLA, 16, 512, 128, 128, 192, True, None, bf16, "mla"),
    ] + [(case, b, sq, h, hkv, d, True, None, f32, "randn")
         for (b, sq, h, hkv, d), case in EXAMPLE_FLASH.items()]
    cases = [c for c in cases if only is None or c[0] in only]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, b, s, h, hkv, d, causal, window, dt, inputs in cases:
        def rand(*shape):
            a = rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(a).to(dev).to(dt)
        if inputs == "qkv":
            qkv = rand(b, s, 3 * h, d)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
        else:
            q, k, v = rand(b, s, h, d), rand(b, s, hkv, d), rand(b, s, hkv, d)
        if inputs == "eye":
            v = torch.zeros_like(v)
            v[:, torch.arange(s), :, torch.arange(s)] = 1.0
        if inputs == "mla":
            v[..., 128:] = 0
        kw = dict(causal=causal, window=window)
        p = plan(b, s, h, hkv, d, dt, causal, window)
        want_variant = "fma_f32" if dt != bf16 \
            else "wgmma" if d in (64, 128) else "mma_sync"
        check(p.variant == want_variant, f"flash {name}: variant {p}")
        check(library_smem_bytes(p, d) == p.smem,
              f"flash {name}: the plan's shared memory {p.smem} is not the "
              f"kernel's {library_smem_bytes(p, d)}")
        reset_counts()
        out = flash_attention_bshd(q, k, v, **kw)
        want = attention_bshd_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(dict(flash_attention_bshd.variants) == {want_variant: 1},
              f"flash {name}: calls by variant "
              f"{dict(flash_attention_bshd.variants)}")
        check(out.dtype == want.dtype and out.shape == want.shape,
              f"flash {name}: {out.dtype}{tuple(out.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        err, row_err = _row_scaled(out, want)
        check(row_err <= FLASH_ROW_TOL[dt],
              f"flash {name}: row-scaled error {row_err} > "
              f"{FLASH_ROW_TOL[dt]}")
        if inputs == "mla":
            check(bool((out[..., 128:] == 0).all()),
                  f"flash {name}: the zero columns of v gave nonzero outputs")
        esz = q.element_size()
        bytes_moved = esz * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * d * b * h * _live_pairs(s, causal, window)
        bound_ms, bound_by = _bound(
            bytes_moved, flops,
            BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        ms = time_cuda(lambda: flash_attention_bshd(q, k, v, **kw), flush)
        plain_ms = time_cuda(lambda: attention_bshd_ref(q, k, v, **kw),
                             flush)
        # yardstick only: one PyTorch call for the same function
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            lib = lambda: sdpa(qt, kt, vt, is_causal=causal,  # noqa: E731
                               enable_gqa=True)
        else:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                               enable_gqa=True)
        library_ms = time_cuda(lib, flush)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, variant=p.variant)
        extra = ""
        if name in (FLASH_PATH, FLASH_GRANITE, FLASH_JAMBA,
                    FLASH_WHISPER_ENC):
            # the first design on the same inputs
            scale = d ** -0.5
            old = plan(b, s, h, hkv, d, dt, causal, window,
                       variant="mma_sync")
            old_out = run_plan(old, q, k, v, scale=scale, **kw)
            torch.cuda.synchronize()
            _, old_row_err = _row_scaled(old_out, want)
            check(old_row_err <= FLASH_ROW_TOL[dt],
                  f"flash {name} mma_sync: row-scaled error {old_row_err} > "
                  f"{FLASH_ROW_TOL[dt]}")
            was_ms = time_cuda(
                lambda: run_plan(old, q, k, v, scale=scale, **kw), flush)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CUDA_ITERS):
                flash_attention_bshd(q, k, v, **kw)
            host_us = (time.perf_counter() - t0) / CUDA_ITERS * 1e6
            torch.cuda.synchronize()
            rows[name]["was_ms"] = was_ms
            extra = (f" | mma_sync (was) {was_ms * 1e3:.1f} us (row-scaled "
                     f"{old_row_err:.3g}); {flops / ms / 1e9:.1f} TFLOP/s "
                     f"(mma_sync {flops / was_ms / 1e9:.1f}); host "
                     f"{host_us:.1f} us per call")
        print(f"[kernel] flash_attention {name}: {p.variant} ({p.stages} "
              f"stages, {p.tiles} kv tiles per head); err={err:.3g} "
              f"row-scaled {row_err:.3g} (tol {FLASH_ROW_TOL[dt]:.3g}) | "
              f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
              f"sdpa {library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} "
              f"us ({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{bytes_moved / 1e6:.2f} MB; {100 * bound_ms / ms:.1f}% of "
              f"bound){extra}")
        if name == FLASH_PATH:
            # the denominator: the row sum of the unrounded probabilities
            # (as the TPU kernel) against that of the rounded ones (the
            # first design), both in f32 against the f32 plain version
            want32 = attention_bshd_ref(q.float(), k.float(), v.float(),
                                        **kw)
            before, after = _denominators(q, k, v, d ** -0.5)
            _, e_before = _row_scaled(before, want32)
            _, e_after = _row_scaled(after, want32)
            _, e_kernel = _row_scaled(out, want32)
            del want32, before, after
            print(f"[kernel] flash_attention {name}: row-scaled error "
                  f"against the f32 plain version, probabilities rounded to "
                  f"bf16 for PV, f32 output: row sum of the rounded values "
                  f"(before) {e_before:.3g}, of the unrounded ones (after) "
                  f"{e_after:.3g}; the kernel's bf16 output {e_kernel:.3g}")
    del flush
    return rows


#: the published widths a phase asserts before it builds one of these
#: archs at full width: arch -> (the config tuple, its value)
ARCH_CONFIGS = {
    "qwen2-7b": (
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd,
                   c.d_ff, c.vocab, c.dtype),
        (28, 3584, 28, 4, 128, 18944, 152064, "bfloat16")),
    "granite-moe-1b-a400m": (
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd,
                   c.moe.n_experts, c.moe.top_k, c.moe.d_ff_expert, c.vocab,
                   c.tie_embeddings, c.dtype),
        (24, 1024, 16, 8, 64, 32, 8, 512, 49155, True, "bfloat16")),
    "mamba2-2.7b": (
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.mamba.expand,
                   c.mamba.head_dim, c.mamba.d_state, c.mamba.n_groups,
                   c.mamba.conv_width, c.mamba.chunk, c.vocab, c.dtype),
        (64, 2560, 0, 2, 64, 128, 1, 4, 256, 50280, "bfloat16")),
    "jamba-v0.1-52b": (
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd,
                   c.moe.n_experts, c.moe.top_k, c.moe.d_ff_expert, c.d_ff,
                   c.mamba.d_state, c.mamba.head_dim, c.vocab, c.dtype),
        (32, 4096, 32, 8, 128, 16, 2, 14336, 14336, 16, 64, 65536,
         "bfloat16")),
    "deepseek-v3-671b": (
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.attn_kind,
                   c.mla.q_lora_rank, c.mla.kv_lora_rank,
                   c.mla.qk_rope_head_dim, c.mla.qk_nope_head_dim,
                   c.mla.v_head_dim, c.moe.n_experts, c.moe.top_k,
                   c.moe.d_ff_expert, c.moe.n_shared_experts,
                   c.moe.first_dense_layers, c.d_ff, c.vocab, c.dtype),
        (61, 7168, 128, "mla", 1536, 512, 64, 128, 128, 256, 8, 2048, 1, 3,
         18432, 129280, "bfloat16")),
    "qwen2-vl-7b": (
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd,
                   c.d_ff, c.vocab, c.qkv_bias, c.mrope, c.mrope_sections,
                   c.frontend, c.n_frontend_tokens, c.rope_theta, c.dtype),
        (28, 3584, 28, 4, 128, 18944, 152064, True, True, (16, 24, 24),
         "vision", 256, 1e6, "bfloat16")),
    "whisper-tiny": (
        lambda c: (c.n_layers, c.n_enc_layers, c.is_encdec, c.d_model,
                   c.n_heads, c.n_kv_heads, c.hd, c.d_ff, c.vocab,
                   c.frontend, c.n_frontend_tokens, c.dtype),
        (4, 4, True, 384, 6, 6, 64, 1536, 51865, "audio", 1500,
         "bfloat16")),
}


def _check_config(arch, cfg):
    """``cfg`` has ``arch``'s published widths (``ARCH_CONFIGS``)."""
    shape_of, want = ARCH_CONFIGS[arch]
    check(shape_of(cfg) == want, f"{arch} config changed: {cfg}")


#: the serving phases, in order: arch -> (each kernel's launches per
#: engine step, the depth served (None: the config's), the longest
#: prompt, the KV capacity of a slot)
SERVE_ARCHS = {
    "qwen2-7b": ({"flash_decode_bhrd": 28}, None, 512, 1024),
    "granite-moe-1b-a400m": (
        {"flash_decode_bhrd": 24, "moe_expert_ffn_ecd": 24}, None, 256, 1024),
    "mamba2-2.7b": ({}, None, 256, 1024),
    # 8 of 32 layers (one interleave period: stacks 3 / 4 / 1); the full
    # depth is ~104 GB in bf16
    "jamba-v0.1-52b": (
        {"flash_decode_bhrd": 1, "moe_expert_ffn_ecd": 4}, 8, 256, 1024),
    # 5 of 61 layers (the 3 dense and 2 MoE: 53.3 GB in bf16, of which
    # 45.1 GB the two layers' experts); the full depth is ~1.3 TB
    "deepseek-v3-671b": (
        {"flash_decode_bhrd": 5, "moe_expert_ffn_ecd": 2}, 5, 256, 1024),
    # text requests, M-RoPE tables at each slot's position
    "qwen2-vl-7b": ({"flash_decode_bhrd": 28}, None, 512, 1024),
    # the decoder at its published context (448); the engine runs no
    # encoder, so the cross-attention reads zero caches, as in the JAX
    # package
    "whisper-tiny": ({"flash_decode_bhrd": 4}, None, 256, 448),
}


def _check_serve_launches(tag, per_step, steps, dtype=torch.bfloat16,
                          fd_variant=None):
    """The decode path's launches since the last reset: each kernel
    ``per_step[name]`` times a step, every other one none; in bf16
    ``flash_decode`` on ``tma_mma`` (``fd_variant`` where the decode
    plans another: MLA's ``fma``) and ``moe_expert_ffn`` on ``wgmma``,
    in f32 both on ``fma``; ``moe_expert_ffn`` always with a fill,
    unpadded."""
    kernels = _path_kernels()
    launches = {fn.__name__: fn.launches for fn in kernels}
    want = {name: per_step.get(name, 0) * steps for name in launches}
    check(launches == want, f"{tag}: launches {launches} for {steps} "
          f"steps, want {want}")
    bf16 = dtype == torch.bfloat16
    fd, moe = kernels[0], kernels[3]
    want_fd, want_moe = ("tma_mma", "wgmma") if bf16 else ("fma", "fma")
    want_fd = fd_variant or want_fd
    check(dict(fd.variants) == ({want_fd: fd.launches} if fd.launches
                                else {}),
          f"{tag}: flash_decode variants {dict(fd.variants)}")
    check(set(moe.variants) <= {want_moe}
          and moe.variants[want_moe] == moe.filled == moe.launches
          and moe.padded == 0,
          f"{tag}: moe_expert_ffn variants {dict(moe.variants)}, filled "
          f"{moe.filled}, padded {moe.padded} of {moe.launches} calls")
    return launches


def serve_arch_phase(arch, seed: int = 0):
    """``arch`` (a key of ``SERVE_ARCHS``) at full width, bf16, through the
    multi-tenant engine: 4 resident nonzero rank-8 adapters, 8 slots,
    the table's KV capacity, 16 requests of 16 to its longest prompt
    and 32 generated tokens; exact launches, decode latency, TTFT,
    tok/s and peak memory, finite logits, then a few profiled engine
    steps. Returns the (``flash_decode``, ``moe_expert_ffn``) launches."""
    import dataclasses

    from repro_torch.analysis import guard_syncs
    from repro_torch.analysis.contracts.serving import check_step_contract
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterRegistry, ServingEngine

    tag = f"serve {arch}"
    per_step, depth, longest, capacity = SERVE_ARCHS[arch]
    cfg = get_config(arch)
    _check_config(arch, cfg)
    full_depth = cfg.n_layers
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    n_slots, n_req, gen_len, n_adapters = 8, 16, 32, 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, g)
    registry = AdapterRegistry.for_model(cfg, rank=8, capacity=n_adapters)
    for i in range(n_adapters):
        registry.add(f"adapter/{i}", _nonzero_lora(T, cfg, g, 8, 0.02))
    engine = ServingEngine(cfg, params, adapters=registry, n_slots=n_slots,
                           kv_capacity=capacity)
    torch.cuda.synchronize()
    sizes = T.stack_sizes(params["blocks"])
    cut = (f"; DEPTH CUT to {depth} of {full_depth} layers (stacks "
           f"{sizes}), widths unreduced" if depth else "")
    print(f"[{tag}] full width: "
          f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params "
          f"({sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9:.2f}"
          f" GB {cfg.dtype}), set-up {time.perf_counter() - t0:.1f} s{cut}")

    rng = np.random.default_rng(np.random.SeedSequence((seed, 2)))
    lens = rng.integers(16, longest + 1, size=n_req)
    prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
               for n in lens]
    _reset_all_counts()
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
    launches = _check_serve_launches(
        tag, per_step, steps, fd_variant=_decode_variant(cfg, torch.bfloat16))
    check(all(r.done for r in reqs), f"{tag}: not every request finished")
    for r in reqs:
        check(len(r.tokens) == gen_len
              and bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"{tag}: request {r.rid} tokens {r.tokens}")
    decode_times = [dt for r in reqs for dt in r.decode_times]
    ttft = [r.ttft_s for r in reqs]
    n_new = sum(len(r.generated) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    per = ", ".join(f"{k} {v} = {per_step[k]} x {steps}"
                    for k, v in launches.items() if v) or "every kernel 0"
    held = _held_cases(cfg, n_slots, capacity, launches)
    print(f"[{tag}] {n_req} requests, prompts {int(lens.min())}-"
          f"{int(lens.max())} (sum {int(lens.sum())}), gen {gen_len}, "
          f"{n_slots} slots, capacity {capacity}, {n_adapters} adapters; "
          f"engine steps {steps} (warm-up {warm_s:.2f} s); launches: {per}; "
          f"shapes held in the kernel phase by {held or 'none'}")
    print(f"[{tag}] TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms | "
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
          f"{tag}: non-finite logits")
    del cache, logits

    for i, p in enumerate(prompts[:n_slots]):
        engine.submit(p[:16], max_new_tokens=8,
                      adapter=f"adapter/{i % n_adapters}")
    for _ in range(4):                                   # into steady state
        engine.step()
    n = 5

    def some_steps():
        for _ in range(n):
            engine.step()
    _profile(tag, f"{n} profiled engine steps", some_steps, n)
    check(engine.has_work(), f"{tag}: no request left for the sync count")
    with guard_syncs("warn") as syncs:
        engine.step()
    print(f"[{tag}] one engine step under guard_syncs('warn'): "
          f"{syncs.count} synchronizing calls")
    while engine.has_work():
        engine.step()
    mismatches = check_step_contract(engine)
    check(not mismatches, f"{tag}: StepContract: {mismatches}")
    print(f"[{tag}] StepContract holds at full width: next tokens "
          f"int32[{n_slots}], the cache's "
          f"{len(_leaves(engine.kv.cache))} leaves keep their shapes and "
          f"dtypes")
    _reset_all_counts()
    return launches["flash_decode_bhrd"], launches["moe_expert_ffn_ecd"]


def _profile(tag, what, fn, n=1):
    """Wall time and device busy share of ``fn()`` under torch.profiler,
    with the kernels that took most device time; ``n`` divides the
    per-call numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] the profiler saw no device activity: busy share "
              f"not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    print(f"[{tag}] {what}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}%, idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}%), {len(kernels) // n} "
          f"kernels per call")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[{tag}]   {t / 1e3 / n:.3f} ms, {c // n} calls per call: "
              f"{name[:90]}")
    for what_, keys in (
            ("lora_matmul forward (pre-pass and main kernel)",
             ("xa_bf16_kernel", "lora_wgmma_kernel")),
            ("flash_attention forward", ("flash_wgmma_kernel",
                                         "flash_bf16_kernel",
                                         "flash_f32_kernel")),
            ("flash_decode", ("decode_mma_kernel",
                              "decode_mma_combine_kernel",
                              "decode_split_kernel",
                              "decode_combine_kernel")),
            ("ssd_scan", ("ssd_mma_kernel", "ssd_scan_kernel")),
            ("moe_expert_ffn", ("ffn_wgmma_kernel", "ffn_bf16_kernel",
                                "ffn_f32_kernel"))):
        hits = [(t, c) for name, (t, c) in by_name.items()
                if any(k in name for k in keys)]
        if hits:
            t = sum(t for t, _ in hits)
            print(f"[{tag}]   {what_}: {t / 1e3 / n:.3f} ms in "
                  f"{sum(c for _, c in hits) // n} launches per call, "
                  f"{100 * t / busy_us:.1f}% of device busy")


#: the reduced archs whose greedy tokens the card and the CPU must agree on
PARITY_ARCHS = ("qwen2-7b", "granite-moe-1b-a400m", "mamba2-2.7b",
                "jamba-v0.1-52b", "deepseek-v3-671b", "qwen2-vl-7b",
                "whisper-tiny")


def parity_phase(seed: int = 0):
    """Reduced qwen2-7b, granite-moe-1b-a400m, mamba2-2.7b,
    jamba-v0.1-52b, deepseek-v3-671b, qwen2-vl-7b and whisper-tiny in
    f32: the card (kernels) and the CPU (plain versions) give the same
    greedy tokens through the multi-tenant engine, with slot
    recycling."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.interop import tree_map
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterRegistry, ServingEngine

    for arch in PARITY_ARCHS:
        cfg = dataclasses.replace(reduce_config(get_config(arch)),
                                  dtype="float32")
        g = torch.Generator(device="cpu").manual_seed(seed)
        params = T.init_params(cfg, g)
        adapters = [_nonzero_lora(T, cfg, g, 4, 0.05) for _ in range(2)]
        rng = np.random.default_rng(np.random.SeedSequence((seed, 3)))
        prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
                   for n in (5, 9, 12, 7)]
        out = {}
        _reset_all_counts()
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t, d=dev: t.to(d), params)
            reg = AdapterRegistry(
                tree_map(lambda t, d=dev: t.to(d), adapters[0]), capacity=2)
            for i, lora in enumerate(adapters):
                reg.add(f"a{i}", tree_map(lambda t, d=dev: t.to(d), lora))
            eng = ServingEngine(cfg, p, adapters=reg, n_slots=2,
                                kv_capacity=24)
            reqs = [eng.submit(pr, max_new_tokens=8, adapter=f"a{i % 2}")
                    for i, pr in enumerate(prompts)]
            while eng.has_work():
                eng.step()
            out[dev] = np.stack([r.tokens for r in reqs])
        launches = {fn.__name__: fn.launches for fn in _path_kernels()
                    if fn.launches}
        check(np.array_equal(out["cuda"], out["cpu"]),
              f"{arch}: greedy tokens differ:\ncuda {out['cuda']}\ncpu  "
              f"{out['cpu']}")
        print(f"[parity] reduced {arch} f32, 4 requests x 8 tokens, 2 "
              f"adapters, 2 slots: cuda == cpu {out['cuda'][0].tolist()} "
              f"...; card launches {launches or 'none'}")
    _reset_all_counts()


#: prefill_vs_decode limit on the row-scaled error of the last-token
#: DeepSeek-V3 under its published rules (``published_deepseek``)
PUBLISHED_DEEPSEEK = "deepseek-v3 published"


def published_deepseek(n_layers: int):
    """deepseek-v3-671b's registry config cut to ``n_layers`` with
    DeepSeek-V3's published rules switched on, as the benchmark's
    ``fedbench/configs/deepseek-v3-8l.json`` sets them: the grouped
    sigmoid router (8 groups, top 4, routed scale 2.5, the sequence-wise
    loss at 1e-4, no drops), experts 0-7 of the router's 256 held, YaRN
    (factor 40 over 4,096 positions, beta 32 / 1, mscale 1 / 1)."""
    import dataclasses

    from repro_torch.configs import RopeScaling, get_config

    cfg = get_config("deepseek-v3-671b")
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        moe=dataclasses.replace(
            cfg.moe, n_experts=8, scoring="sigmoid", n_group=8,
            topk_group=4, routed_scale=2.5, router_aux_coef=1e-4,
            n_routed=256, first_expert=0),
        rope_scaling=RopeScaling(factor=40.0,
                                 original_max_position_embeddings=4096,
                                 beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                                 mscale_all_dim=1.0))


def _random_bias(params, gen, std=0.01):
    """Draw every ``e_score_correction_bias`` N(0, std²) in place, as the
    benchmark's configuration does (zeros would leave selection to the
    scores alone)."""
    for key, val in params.items():
        if isinstance(val, dict):
            _random_bias(val, gen, std)
        elif key == "e_score_correction_bias":
            val.copy_(torch.randn(val.shape, generator=gen,
                                  device=val.device) * std)


#: logits, max |prefill - decode| / max |decode| per row, f32: the JAX
#: package's limit for its SSD kernel against the sequential oracle
#: (the chunked form takes exp of differences of cumulative sums, exact
#: only to ~2.4e-4 at a = -16), which the Mamba layers carry to the
#: logits; the kernels' and cuBLAS's summation orders move the rest by
#: far less
PVD_TOL = 1e-3
#: the variant each kernel plans in f32, the only one prefill_vs_decode
#: may launch
PVD_VARIANTS = {"flash_decode_bhrd": "fma", "lora_matmul_fused": "fma_f32",
                "flash_attention_bshd": "fma_f32",
                "moe_expert_ffn_ecd": "fma", "ssd_scan_bshp": "fma"}
#: arch -> (layers, batch, prefill length); full width, f32.
#: deepseek-v3-671b's 3 layers are its dense MLA prefix (an empty MoE
#: stack): prefill expands k and v from the latent, decoding attends over
#: it in the absorbed formulation (``flash_decode`` at hd 576, vd 512).
#: ``PUBLISHED_DEEPSEEK``'s 4 are 3 dense + 1 MoE layer under the
#: published rules (YaRN in both paths' tables and scale, the grouped
#: sigmoid router over 256 with 8 experts held, no drops in either path).
#: qwen2-vl-7b runs text (M-RoPE with equal streams in both paths);
#: whisper-tiny's 4 are its decoder layers, after its 4 encoder layers
#: over 1500 frames: prefill runs the encoder inside the forward,
#: decoding reads the cross caches filled from ``encoder_kv``
PVD_CASES = {
    "mamba2-2.7b": (4, 2, 300),
    "granite-moe-1b-a400m": (4, 2, 64),
    "jamba-v0.1-52b": (8, 2, 48),
    "deepseek-v3-671b": (3, 2, 48),
    PUBLISHED_DEEPSEEK: (4, 2, 48),
    "qwen2-vl-7b": (2, 2, 48),
    "whisper-tiny": (4, 2, 48),
}


def prefill_vs_decode_phase(seed: int = 0, only=None):
    """f32 at full width, depth cut: prefill's last-token logits through
    the kernels (``ssd_scan``, ``flash_attention``, ``moe_expert_ffn``,
    and ``lora_matmul`` with a shared 2-D LoRA) against teacher-forced
    decoding of the same tokens (``flash_decode`` and ``moe_expert_ffn``
    at capacity 8; the Mamba recurrence and the projections plain). The
    MoE archs run at capacity factor E/k, so neither path drops a
    token. Every kernel runs its f32 variant (``PVD_VARIANTS``), so for
    mamba2 this holds the recurrence against ``ssd_scan``'s ``fma``
    variant; the bf16 ``mma`` variant is held by the ssd phase. ``only``:
    the ``PVD_CASES`` to run (all where None)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    for arch, (layers, b, s) in PVD_CASES.items():
        if only is not None and arch not in only:
            continue
        tag = f"prefill_vs_decode {arch}"
        cfg = dataclasses.replace(
            published_deepseek(layers) if arch == PUBLISHED_DEEPSEEK
            else get_config(arch), n_layers=layers, dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        torch.cuda.empty_cache()
        g = torch.Generator(device="cuda").manual_seed(seed)
        params = T.init_params(cfg, g)
        _random_bias(params, g)
        lora = _nonzero_lora(T, cfg, g, 8, 0.02)
        kinds = T.stack_kinds(cfg)
        n_of = {kind: 0 for kind in T.PORTED_KINDS}
        for name, _ in T.execution_order(cfg):
            n_of[kinds[name]] += 1
        n_mamba = sum(v for k, v in n_of.items() if k.startswith("mamba"))
        n_attn = sum(v for k, v in n_of.items()
                     if k.startswith("gqa") or k == "dec")
        n_mla = sum(v for k, v in n_of.items() if k.startswith("mla"))
        n_moe = sum(v for k, v in n_of.items() if k.endswith("moe"))
        n_enc = n_of["enc"]                  # frozen: no adapter, no cache
        rng = np.random.default_rng(np.random.SeedSequence((seed, 23)))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).cuda()
        batch = {"tokens": tokens}
        if cfg.is_encdec:
            batch["audio_embeds"] = torch.from_numpy(rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model),
                dtype=np.float32)).cuda()
        _reset_all_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            want = T.prefill(cfg, params, lora, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = {fn.__name__: fn.launches for fn in _path_kernels()}
        check(pre == {"flash_decode_bhrd": 0,
                      "lora_matmul_fused": 2 * (n_mamba + n_attn + n_mla),
                      "flash_attention_bshd": n_attn + n_enc + n_mla,
                      "moe_expert_ffn_ecd": n_moe,
                      "ssd_scan_bshp": n_mamba},
              f"{tag}: prefill launches {pre}")
        variants = {fn.__name__: dict(fn.variants) for fn in _path_kernels()}
        check(variants == {k: {PVD_VARIANTS[k]: n} if n else {}
                           for k, n in pre.items()},
              f"{tag}: prefill variants {variants}")
        cache = T.init_cache(cfg, b, s, device="cuda")
        if cfg.is_encdec:
            dec = cache["stacks"]["dec"]
            with torch.no_grad():
                dec["cross_k"][:], dec["cross_v"][:] = T.encoder_kv(
                    cfg, params, batch["audio_embeds"])
        _reset_all_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(s):
                got, cache = T.decode_step(cfg, params, lora,
                                           tokens[:, i:i + 1], cache)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        _check_serve_launches(tag, {"flash_decode_bhrd": n_attn + n_mla,
                                    "moe_expert_ffn_ecd": n_moe}, s,
                              torch.float32)
        live = slice(0, cfg.vocab)
        err, row = _row_scaled(got[..., live], want[..., live])
        check(bool(torch.isfinite(want[..., live]).all())
              and row <= PVD_TOL,
              f"{tag}: row-scaled error {row} > {PVD_TOL} (abs {err})")
        print(f"[pvd] {arch} f32 full width, {layers} layers ({n_mamba} "
              f"Mamba, {n_attn} attention, {n_mla} MLA, {n_moe} MoE; "
              f"{n_enc} encoder layers before them), B{b} S{s}: prefill "
              f"{prefill_s * 1e3:.1f} ms through the kernels {pre}, all on "
              f"their f32 variants; "
              f"teacher-forced decode {s} steps {decode_s:.2f} s; last-token "
              f"logits max abs err {err:.3g}, row-scaled {row:.3g} (tol "
              f"{PVD_TOL})")
        del params, lora, cache
    _reset_all_counts()
    torch.cuda.empty_cache()


def _nonzero_lora(T, cfg, gen, rank, std):
    """``init_lora`` with random ``b`` (zero ``b`` would leave the
    adapters' product zero and the gradient of ``a`` zero)."""
    lora = T.init_lora(cfg, gen, rank=rank)
    for stack in lora.values():
        for ab in stack.values():
            ab["b"].normal_(0.0, std, generator=gen)
    return lora


def train_phase(seed: int = 0):
    """llama2-7b-proxy at full width: federated rounds (2 clients x K=2
    local AdamW steps, fedavg) through make_federated_round_step, timed
    warm."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import (client_round_batches,
                                            make_federated_data)
    from repro_torch.federated.client import make_local_train
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.kernels.flash_attention import (
        reset_counts as reset_flash_counts)
    from repro_torch.kernels.flash_decode import flash_decode_bhrd
    from repro_torch.kernels.lora_matmul import (lora_matmul_fused,
                                                 reset_counts)
    from repro_torch.kernels.moe_ffn import moe_expert_ffn_ecd
    from repro_torch.kernels.ssd_scan import ssd_scan_bshp
    from repro_torch.launch.steps import make_federated_round_step
    from repro_torch.models import transformer as T

    cfg = get_config("llama2-7b-proxy")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab, cfg.dtype)
          == (32, 4096, 32, 32, 128, 11008, 32000, "bfloat16"),
          f"llama2-7b-proxy config changed: {cfg}")
    n_clients, k_local, batch, seq, rank, lr = 2, 2, 4, 1024, 32, 1e-4
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, g)
    lora = _nonzero_lora(T, cfg, g, rank, 0.02)
    data = make_federated_data(cfg.vocab, n_clients=20, seed=seed)
    batches = client_round_batches(data, list(range(n_clients)), k_local,
                                   batch, seq, (seed, 0))
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in _leaves(params))
    print(f"[train] llama2-7b-proxy full width: {n_param / 1e9:.3f} B params "
          f"({sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9:.2f}"
          f" GB {cfg.dtype}), rank-{rank} f32 LoRA "
          f"({sum(p.numel() for p in _leaves(lora)) / 1e6:.2f} M params), "
          f"batches {tuple(batches['tokens'].shape)}, set-up "
          f"{time.perf_counter() - t0:.1f} s")

    round_step = make_federated_round_step(cfg, k_local=k_local, remat=False)
    kernels = (flash_decode_bhrd, lora_matmul_fused, flash_attention_bshd,
               moe_expert_ffn_ecd, ssd_scan_bshp)
    local = make_local_train(cfg)
    one = {k: v[0, :1] for k, v in batches.items()}
    # one untimed local step first: cuBLAS's first use at these shapes
    # and the allocator's growth stay out of the timed rounds
    local(params, lora, one, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forwards = n_clients * k_local
    want = {"flash_decode_bhrd": 0,
            "lora_matmul_fused": 2 * cfg.n_layers * forwards,
            "flash_attention_bshd": cfg.n_layers * forwards,
            "moe_expert_ffn_ecd": 0, "ssd_scan_bshp": 0}
    walls = []
    for _ in range(TRAIN_ROUNDS):
        for fn in kernels:
            fn.launches = 0
        reset_counts()
        reset_flash_counts()
        t0 = time.perf_counter()
        new_lora, loss = round_step(params, lora, batches, lr)
        loss = float(loss)                               # waits
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in kernels}
        check(launches == want, f"launches {launches}, want {want} (the "
              f"backward launches no kernel)")
        _check_lora_variants(lora_matmul_fused, "train")
        _check_flash_variant(flash_attention_bshd, "train")
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls))

    check(np.isfinite(loss), f"round loss {loss}")
    old, new = _leaves(lora), _leaves(new_lora)
    check(all(bool(torch.isfinite(b).all()) for b in new),
          "non-finite aggregated LoRA")
    check(all(not torch.equal(a, b) for a, b in zip(old, new)),
          "the aggregated LoRA equals the incoming one")
    tokens = forwards * batch * seq
    print(f"[train] fedavg round, {n_clients} clients x {k_local} local "
          f"steps x {batch} x {seq} tokens, lr {lr}, {TRAIN_ROUNDS} warm "
          f"rounds: walls {', '.join(f'{w:.3f}' for w in walls)} s; median "
          f"{wall / forwards * 1e3:.1f} ms per local step, "
          f"{tokens / wall:.0f} tokens/s, mean last loss {loss:.4f}, max "
          f"memory allocated {peak / 2**30:.2f} GiB")
    print(f"[train] launches per round {launches} = {forwards} forwards x "
          f"(2 x {cfg.n_layers}, {cfg.n_layers})")

    _profile("train", "one profiled local step (forward, backward, AdamW)",
             lambda: local(params, lora, one, lr))
    return cfg, params, lora, batches, launches


def train_parity_phase(cfg, params, lora, batches, seed: int = 0):
    """The kernels' numerics in the model: full width through the kernels
    vs the plain path on the card; reduced models, card vs CPU."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.federated.client import make_local_train
    from repro_torch.interop import tree_map
    from repro_torch.models import transformer as T

    # full width, one batch: the two paths round bf16 at other places
    # (the kernels are f32 inside), as the JAX backends do: 1e-2 relative
    batch = {k: v[0, 0] for k, v in batches.items()}
    with torch.no_grad():
        kern, _ = T.loss_fn(cfg, params, lora, batch)
        plain, _ = T.loss_fn(dataclasses.replace(
            cfg, kernel_backend="reference"), params, lora, batch)
    rel = abs(float(kern) - float(plain)) / abs(float(plain))
    check(rel <= 1e-2, f"full-width loss: kernels {float(kern)} vs plain "
          f"{float(plain)} (rel {rel})")
    print(f"[train-parity] llama2-7b-proxy full width, 4 x 1024 tokens: "
          f"loss through the kernels {float(kern):.5f}, plain path "
          f"{float(plain):.5f}, rel diff {rel:.3g} (tol 1e-2)")

    rng = np.random.default_rng(np.random.SeedSequence((seed, 6)))

    def to(tree, dev):
        return tree_map(lambda t: t.to(dev), tree)

    for arch in ("llama2-7b-proxy", "qwen2-7b", "mamba2-2.7b",
                 "qwen2-vl-7b", "whisper-tiny"):
        rcfg = dataclasses.replace(reduce_config(get_config(arch)),
                                   dtype="float32")
        gen = torch.Generator(device="cpu").manual_seed(seed)
        rp = T.init_params(rcfg, gen)
        rl = _nonzero_lora(T, rcfg, gen, 8, 0.05)
        tok = rng.integers(0, rcfg.vocab, size=(2, 100), dtype=np.int32)
        lab = rng.integers(0, rcfg.vocab, size=(2, 100), dtype=np.int32)
        b1 = {"tokens": tok, "labels": lab}
        if rcfg.frontend:          # the vision prefix or the audio frames
            b1[f"{rcfg.frontend}_embeds"] = rng.standard_normal(
                (2, rcfg.n_frontend_tokens, rcfg.d_model), dtype=np.float32)
        # f32: summation order only, rtol = atol = 1e-4
        got = T.loss_and_lora_grads(rcfg, to(rp, "cuda"), to(rl, "cuda"), b1)
        want = T.loss_and_lora_grads(rcfg, rp, rl, b1)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4,
                                   atol=1e-4)
        worst = 0.0
        for a, b in zip(_leaves(got[2]), _leaves(want[2])):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
            worst = max(worst, float((a.cpu() - b).abs().max()))
        print(f"[train-parity] reduced {arch} f32: loss cuda "
              f"{float(got[0]):.6f} cpu {float(want[0]):.6f}, max |grad "
              f"diff| {worst:.3g} over {len(_leaves(want[2]))} LoRA leaves")
        if arch != "llama2-7b-proxy":
            continue
        # three local AdamW steps; Adam moves each element by ~lr
        # whatever its gradient, so leaves at 2 * lr * K, and the update
        k_steps, lr = 3, 1e-3
        bt = {"tokens": rng.integers(0, rcfg.vocab, (k_steps, 2, 100),
                                     dtype=np.int32),
              "labels": rng.integers(0, rcfg.vocab, (k_steps, 2, 100),
                                     dtype=np.int32)}
        local = make_local_train(rcfg)
        lc, mc = local(to(rp, "cuda"), to(rl, "cuda"), bt, lr)
        lh, mh = local(rp, rl, bt, lr)
        for key in ("loss_first", "loss_last"):
            torch.testing.assert_close(mc[key].cpu(), mh[key], rtol=1e-3,
                                       atol=1e-3)
        for a, b, old in zip(_leaves(lc), _leaves(lh), _leaves(rl)):
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=2 * lr * k_steps)
            # the update itself agrees to f32 rounding but for elements
            # whose gradient is within noise of zero: 1e-3 * lr on 99%
            off = ((a.cpu() - old) - (b - old)).abs() > 1e-3 * lr
            check(float(off.float().mean()) <= 0.01,
                  f"local train updates differ on {float(off.float().mean())}"
                  f" of a {tuple(old.shape)} leaf")
        print(f"[train-parity] reduced {arch} f32, make_local_train K=3: "
              f"losses cuda {float(mc['loss_first']):.6f} -> "
              f"{float(mc['loss_last']):.6f}, cpu "
              f"{float(mh['loss_first']):.6f} -> {float(mh['loss_last']):.6f}")


#: moe_expert_ffn limits on the row-scaled error (max |out - want| /
#: max |want| over each (expert, slot) row that is not empty). f32: 1e-5
#: against both versions, summation order only. bf16: 2**-5 against the
#: plain version, which rounds gate, up, the SwiGLU and the hidden to
#: bf16 where the kernel rounds the hidden only (up to four bf16 ulps of
#: the row's size); 2**-6 against the kernel's own arithmetic in plain
#: PyTorch (f32 inside, one rounding), from which it differs by the
#: hidden's rounding and the output's. Empty rows must be exact zeros.
MOE_ROW_TOL = {torch.float32: (1e-5, 1e-5),
               torch.bfloat16: (2.0 ** -5, 2.0 ** -6)}


#: the moe_expert_ffn case of the ``kernels`` line (one MoE layer of the
#: granite-moe-1b-a400m training step)
MOE_PATH = "path E32 C1280 d1024 ff512 bf16"
#: one MoE layer of a decode step at 8 slots (capacity 8): granite-moe-
#: 1b-a400m and jamba-v0.1-52b
MOE_DECODE_GRANITE = "granite decode E32 C8 d1024 ff512 bf16"
MOE_DECODE_JAMBA = "jamba decode E16 C8 d4096 ff14336 bf16"
#: deepseek-v3-671b's at 8 slots (256 experts, top 8, capacity 8)
MOE_DECODE_DEEPSEEK = "deepseek decode E256 C8 d7168 ff2048 bf16"
#: one MoE layer of the DevFT training steps (4 x 1024 tokens):
#: jamba-v0.1-52b (top 2 of 16, capacity 640) and deepseek-v3-671b (top 8
#: of 256, capacity 160)
MOE_JAMBA = "jamba train E16 C640 d4096 ff14336 bf16"
MOE_DEEPSEEK = "deepseek train E256 C160 d7168 ff2048 bf16"
#: the deepseek-v3-8l.devft cell's MoE layer: 8 held experts of 256, a row
#: for every one of the 16 x 512 tokens (no drops), about 8192 x 8 / 256
#: = 256 rows of each live (the fill)
MOE_DEEPSEEK_SHARE = "deepseek-v3-8l train E8 C8192 d7168 ff2048 bf16"
#: moe_block_ep's buffers in granite-moe-1b-a400m's training step on the
#: 1x1 mesh (4 x 1024 tokens, top 8 of 32): the local capacity
#: max(8, ceil(4096 * 8 / 32) * 2) = 2048, with the fill
MOE_EP = "ep E32 C2048 d1024 ff512 bf16"
#: every moe_expert_ffn shape a serving phase launches, bf16: (experts,
#: capacity, d, ff) -> the kernel phase's case that holds it
SERVED_MOE = {(32, 8, 1024, 512): MOE_DECODE_GRANITE,
              (16, 8, 4096, 14336): MOE_DECODE_JAMBA,
              (256, 8, 7168, 2048): MOE_DECODE_DEEPSEEK}


def _check_moe_variant(moe_expert_ffn_ecd, tag):
    """Every moe_expert_ffn call since the last ``reset_counts`` ran the
    wgmma kernel with a fill, unpadded."""
    fn = moe_expert_ffn_ecd
    check(set(fn.variants) <= {"wgmma"} and fn.variants["wgmma"] == fn.launches
          and fn.filled == fn.launches and fn.padded == 0,
          f"{tag}: moe_expert_ffn variants {dict(fn.variants)}, filled "
          f"{fn.filled}, padded {fn.padded} of {fn.launches} calls")
    if fn.launches:
        print(f"[{tag}] moe_expert_ffn: all {fn.launches} calls on the wgmma "
              f"kernel with a fill, unpadded")


def moe_phase(moe_expert_ffn_ecd, moe_expert_ffn_ref, seed: int = 0,
              only=None):
    """moe_expert_ffn vs its plain version; the path shape is one MoE
    layer of the granite-moe-1b-a400m training step (4 x 1024 tokens,
    top 8 of 32 experts, capacity 1280). Each case prints its variant,
    whether it padded, two calls' bit-equality, host time and CUDA
    kernels per call, and on bf16 cases the first design's (mma_sync)
    time on the same inputs. Cases with empty rows also run with the
    fill (each expert's live rows): the result must be the same bits,
    and rows past the fill must come out zero even where buf holds
    values there; their bound counts the live rows only. A case whose
    empty rows are a number draws each expert's fill around it (a share
    of a wide router). ``only``: the names of the cases to run (all where
    None)."""
    from repro_torch.kernels.moe_ffn import (live_tiles, plan, reset_counts,
                                             run_plan)

    dev = "cuda"
    rng = np.random.default_rng(np.random.SeedSequence((seed, 7)))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16
    cases = [  # name, E, C, d, ff, dtype, empty rows, variant
        (MOE_PATH, 32, 1280, 1024, 512, bf16, False, "wgmma"),
        ("path E32 C1280 d1024 ff512 f32", 32, 1280, 1024, 512,
         torch.float32, False, "fma"),
        ("path with empty experts bf16", 32, 1280, 1024, 512, bf16, True,
         "wgmma"),
        ("ragged E8 C1000 d1000 ff500 bf16", 8, 1000, 1000, 500, bf16, True,
         "wgmma"),
        ("ragged E3 C77 d1001 ff91 bf16", 3, 77, 1001, 91, bf16, True,
         "wgmma"),
        ("ragged E3 C77 d1001 ff91 f32", 3, 77, 1001, 91, torch.float32,
         True, "fma"),
        # decode: one 128-row tile an expert holds the 8 rows; its TMA
        # boxes run past C (rows load as zeros, stores are clipped)
        (MOE_DECODE_GRANITE, 32, 8, 1024, 512, bf16, True, "wgmma"),
        (MOE_DECODE_JAMBA, 16, 8, 4096, 14336, bf16, True, "wgmma"),
        (MOE_DECODE_DEEPSEEK, 256, 8, 7168, 2048, bf16, True, "wgmma"),
        (MOE_EP, 32, 2048, 1024, 512, bf16, True, "wgmma"),
        (MOE_JAMBA, 16, 640, 4096, 14336, bf16, False, "wgmma"),
        # 22.5 GB of expert weights: the f32-inside version is built
        # 16 experts at a time
        (MOE_DEEPSEEK, 256, 160, 7168, 2048, bf16, False, "wgmma"),
        (MOE_DEEPSEEK_SHARE, 8, 8192, 7168, 2048, bf16, 256, "wgmma"),
    ] + [(case, e, c, d, ff, torch.float32, True, "fma")
         for (e, c, d, ff), case in EXAMPLE_MOE.items()]
    cases = [c for c in cases if only is None or c[0] in only]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def bmm_ffn(buf, wg, wu, wd):
        h = torch.nn.functional.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
        return torch.bmm(h, wd)

    rows = {}
    for name, e, c, d, ff, dt, empty, want_variant in cases:
        def rand(*shape, std=1.0):
            if math.prod(shape) > 1 << 26:     # jamba's experts: on the card
                return torch.randn(shape, generator=gen, device=dev
                                   ).mul_(std).to(dt)
            a = rng.standard_normal(shape, dtype=np.float32) * std
            return torch.from_numpy(a).to(dev).to(dt)
        buf = rand(e, c, d)
        wg, wu = rand(e, d, ff, std=d ** -0.5), rand(e, d, ff, std=d ** -0.5)
        wd = rand(e, ff, d, std=ff ** -0.5)
        fill = None
        if empty is True:
            # slots past each expert's fill are zero, and a few experts
            # got no token at all
            fill = torch.from_numpy(rng.integers(0, c + 1, size=e)).to(dev)
            fill[:max(1, e // 8)] = 0
            fill = fill.int()
        elif empty:
            fill = torch.from_numpy(rng.integers(
                empty // 2, 3 * empty // 2 + 1, size=e)).to(dev).int()
        if fill is not None:
            buf *= (torch.arange(c, device=dev)[None, :]
                    < fill[:, None])[..., None].to(dt)
        p = plan(e, c, d, ff, dt)
        check(p.variant == want_variant,
              f"moe {name}: plan picked {p.variant}, want {want_variant}")
        reset_counts()
        out = moe_expert_ffn_ecd(buf, wg, wu, wd)
        again = moe_expert_ffn_ecd(buf, wg, wu, wd)
        want = moe_expert_ffn_ref(buf, wg, wu, wd)
        f32 = torch.cat([moe_expert_ffn_ref(
            buf[i:i + 16].float(), wg[i:i + 16].float(), wu[i:i + 16].float(),
            wd[i:i + 16].float()) for i in range(0, e, 16)])
        torch.cuda.synchronize()
        check(dict(moe_expert_ffn_ecd.variants) == {want_variant: 2},
              f"moe {name}: calls by variant "
              f"{dict(moe_expert_ffn_ecd.variants)}")
        check(torch.equal(out, again), f"moe {name}: two calls differ")
        check(out.dtype == want.dtype and out.shape == want.shape,
              f"moe {name}: {out.dtype}{tuple(out.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        live = (buf != 0).any(-1)
        check(bool((out[~live] == 0).all()),
              f"moe {name}: an empty row is not exactly zero")
        if empty:
            check(bool((~live).any()), f"moe {name}: no empty row")
        size = want.float().abs().amax(-1)[live]
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        row_err = float((diff.amax(-1)[live] / size).max())
        row_err32 = float(((out.float() - f32).abs().amax(-1)[live]
                           / f32.abs().amax(-1)[live]).max())
        tol, tol32 = MOE_ROW_TOL[dt]
        check(row_err <= tol,
              f"moe {name}: row-scaled error vs plain {row_err} > {tol}")
        check(row_err32 <= tol32, f"moe {name}: row-scaled error vs the "
              f"f32-inside version {row_err32} > {tol32}")
        esz = buf.element_size()
        bytes_moved = esz * (2 * buf.numel() + wg.numel() + wu.numel()
                             + wd.numel())
        flops = 6 * e * c * d * ff
        peak = BF16_FLOPS if dt == bf16 else F32_FLOPS
        bound_ms, bound_by = _bound(bytes_moved, flops, peak)
        call = lambda: moe_expert_ffn_ecd(buf, wg, wu, wd)  # noqa: E731
        ms = time_cuda(call, flush)
        plain_ms = time_cuda(lambda: moe_expert_ffn_ref(buf, wg, wu, wd),
                             flush)
        # yardstick only: the same function as three torch.bmm calls and
        # silu * mul; no single PyTorch call computes it, so the kernels
        # line carries library_ms null
        bmm_ms = time_cuda(lambda: bmm_ffn(buf, wg, wu, wd), flush)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CUDA_ITERS):
            call()
        host_us = (time.perf_counter() - t0) / CUDA_ITERS * 1e6
        torch.cuda.synchronize()
        per_call = _kernels_per_call(call)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None, variant=p.variant,
                          padded=p.padded, bmm_ms=bmm_ms, host_us=host_us,
                          kernels_per_call=per_call)
        extra = ""
        if dt == bf16:
            # the first design (mma_sync) on the same inputs
            old = plan(e, c, d, ff, dt, variant="mma_sync")
            old_out = run_plan(old, buf, wg, wu, wd)
            torch.cuda.synchronize()
            old_err = float(((old_out.float() - want.float()).abs().amax(-1)
                             [live] / size).max())
            check(old_err <= tol, f"moe {name} mma_sync: row-scaled error "
                  f"{old_err} > {tol}")
            was_ms = time_cuda(lambda: run_plan(old, buf, wg, wu, wd), flush)
            rows[name].update(was_ms=was_ms)
            extra += f" | mma_sync (was) {was_ms * 1e3:.1f} us"
        if fill is not None:
            # the fill: the same bits where buf is zero past it, and zeros
            # past it whatever buf holds there
            filled = moe_expert_ffn_ecd(buf, wg, wu, wd, fill=fill)
            past = torch.arange(c, device=dev)[None, :] >= fill[:, None]
            dirty = buf + rand(e, c, d) * past[..., None].to(dt)
            filled_dirty = moe_expert_ffn_ecd(dirty, wg, wu, wd, fill=fill)
            torch.cuda.synchronize()
            check(torch.equal(filled, out), f"moe {name}: the call with the "
                  f"fill differs from the call without it")
            check(bool((filled_dirty[past] == 0).all())
                  and torch.equal(filled_dirty[~past], out[~past]),
                  f"moe {name}: with the fill, rows past it are not zero or "
                  f"the live rows changed where buf is not zero past it")
            fill_host = [int(f) for f in fill.tolist()]
            n_live = sum(fill_host)
            live_experts = sum(1 for f in fill_host if f > 0)
            fill_flops = 6 * n_live * d * ff
            # live rows of buf read, every output row written, the weights
            # of experts with a live row read
            fill_bytes = esz * (n_live * d + e * c * d
                                + 3 * live_experts * d * ff)
            fill_bound_ms, fill_by = _bound(fill_bytes, fill_flops, peak)
            fill_ms = time_cuda(
                lambda: moe_expert_ffn_ecd(buf, wg, wu, wd, fill=fill), flush)
            tiles = live_tiles(p, c, fill_host)
            rows[name].update(fill_ms=fill_ms, fill_bound_ms=fill_bound_ms,
                              fill_bound_by=fill_by)
            extra += (f" | with fill ({n_live} of {e * c} rows live, tiles "
                      f"{tiles[0]}/{math.prod(p.grid1)} + {tiles[1]}/"
                      f"{math.prod(p.grid2)}): bit-equal, zeros past the "
                      f"fill over nonzero buf; {fill_ms * 1e3:.1f} us, bound "
                      f"{fill_bound_ms * 1e3:.2f} us ({fill_by}; "
                      f"{fill_flops / 1e9:.2f} GFLOP, {fill_bytes / 1e6:.2f} "
                      f"MB; {100 * fill_bound_ms / fill_ms:.1f}% of bound)")
        print(f"[kernel] moe_expert_ffn {name}: {p.variant}, "
              f"{'padded' if p.padded else 'not padded'}, block_n "
              f"{p.block_n}, grids {math.prod(p.grid1)} + {math.prod(p.grid2)}"
              f"; two calls bit-equal | err={err:.3g} row-scaled "
              f"{row_err:.3g} (tol {tol:.3g}), vs f32-inside "
              f"{row_err32:.3g} (tol {tol32:.3g}), empty rows "
              f"{int((~live).sum())} exact zeros | kernel "
              f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bmm x3 "
              f"{bmm_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{bytes_moved / 1e6:.2f} MB; {100 * bound_ms / ms:.1f}% of "
              f"bound, {flops / ms / 1e9:.1f} TFLOP/s); host "
              f"{host_us:.1f} us per call; {per_call:g} CUDA kernels per "
              f"call{extra}")
        del buf, wg, wu, wd, out, again, want, f32
        torch.cuda.empty_cache()
    del flush
    return rows


#: ssd_scan limits on the slice-scaled error: max |out - want| over each
#: (batch, head) slice of S x P outputs, divided by that slice's largest
#: |want|. Not per row: an output is a difference of terms (the intra-
#: and inter-chunk sums) that can be much larger than it, so a row can
#: be small beside the roundings of its terms; the slice's largest
#: output is the size of those terms. Held against the chunked plain
#: version and the f32 sequential oracle (on f32 copies of the same
#: inputs). f32: 1e-3 against both, the JAX package's own limit for its
#: SSD kernel against the oracle: the chunked form takes exp of
#: differences of cumulative sums, which reach ~-3000 within a chunk at
#: a = -16 and are exact only to ~2.4e-4 there, and the kernel and the
#: plain version sum them in another order. bf16: 2**-5 against the
#: plain version, which rounds its weights, dt, both terms and their sum
#: to bf16 (a few bf16 ulps, 2**-8 each, of the slice's size) where the
#: kernel rounds the output only; 2**-7 against the oracle (the output's
#: own rounding, at most half an ulp of the slice's largest output,
#: plus the f32 error above).
SSD_TOL = {torch.float32: (1e-3, 1e-3),
           torch.bfloat16: (2.0 ** -5, 2.0 ** -7)}


def _slice_scaled(got, want):
    """(max abs error, max over (batch, head) slices of max|got - want| /
    max|want|) for (B, S, H, P) outputs."""
    diff = (got.float() - want.float()).abs()
    size = want.float().abs().amax(dim=(1, 3))
    return float(diff.max()), float((diff.amax(dim=(1, 3)) / size).max())


def _ssd_flops(bsz, s, h, p, n, chunk):
    """FLOPs the SSD forward needs on this shape: per (batch, head) and
    chunk of c rows, the scores c_i . b_j and the weighted sum over x on
    the c (c + 1) / 2 live causal pairs; the inter-chunk term for every
    chunk but the first (the state entering it is zero) and the state
    update for every chunk but the last (no later chunk reads it)."""
    chunk = min(chunk, s)
    lens = [min(chunk, s - s0) for s0 in range(0, s, chunk)]
    pairs = sum(c * (c + 1) // 2 for c in lens)
    inter = sum(lens[1:]) * 2 * n * p
    update = sum(lens[:-1]) * 2 * n * p
    return bsz * h * (pairs * 2 * (n + p) + inter + update)


#: the ssd_scan case of the ``kernels`` line: one Mamba-2 layer of the
#: mamba2-2.7b training step
SSD_PATH = "path B4 S1024 H80 P64 N128 G1 c256 bf16"
#: one Mamba-2 layer of jamba-v0.1-52b's DevFT step (d_inner 8192)
SSD_JAMBA = "jamba path B4 S1024 H128 P64 N16 G1 c256 bf16"


def _check_ssd_variant(ssd_scan_bshp, tag):
    """Every ssd_scan call since the last ``reset_counts`` ran the mma
    kernel."""
    fn = ssd_scan_bshp
    check(set(fn.variants) <= {"mma"} and fn.variants["mma"] == fn.launches,
          f"{tag}: ssd_scan variants {dict(fn.variants)} of {fn.launches} "
          f"calls")
    if fn.launches:
        print(f"[{tag}] ssd_scan: all {fn.launches} calls on the mma kernel")


def ssd_phase(ssd_scan_bshp, ssd_chunked_ref, ssd_oracle, seed: int = 0):
    """ssd_scan vs its plain chunked version and the f32 sequential
    oracle; the path shape is one Mamba-2 layer of the mamba2-2.7b
    training step (4 x 1024 tokens, 80 heads of 64, N 128, G 1, chunk
    256), x, b and c read in place from one conv output as on the path.
    Each case prints its variant, the error's margin under both limits,
    whether two calls gave the same bits, the workspace, host time and
    CUDA kernels per call, and for mma cases the first design's (fma)
    time on the same inputs."""
    from repro_torch.kernels.ssd_scan import (aligned, library_smem_bytes,
                                              plan, reset_counts, run_plan,
                                              sm_count)

    dev = "cuda"
    rng = np.random.default_rng(np.random.SeedSequence((seed, 9)))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, S, H, P, G, N, chunk, dtype, decay, empty dt
        # rows, x/b/c offset (elements) in the conv output, variant
        (SSD_PATH, 4, 1024, 80, 64, 1, 128, 256, bf16, "model", False, 0,
         "mma"),
        (SSD_JAMBA, 4, 1024, 128, 64, 1, 16, 256, bf16, "model", False, 0,
         "mma"),
        ("path B4 S1024 H80 P64 N128 G1 c256 f32", 4, 1024, 80, 64, 1, 128,
         256, f32, "model", False, 0, "fma"),
        ("ragged S1000 bf16", 4, 1000, 80, 64, 1, 128, 256, bf16, "model",
         False, 0, "mma"),
        ("groups H64 G8 bf16", 2, 1024, 64, 64, 8, 128, 256, bf16, "model",
         False, 0, "mma"),
        ("underflow a=-16 dt~3 bf16", 2, 1024, 80, 64, 1, 128, 256, bf16,
         "strong", False, 0, "mma"),
        ("underflow a=-16 dt~3 f32", 2, 1024, 16, 64, 1, 128, 256, f32,
         "strong", False, 0, "fma"),
        ("empty dt rows bf16", 2, 1024, 80, 64, 1, 128, 256, bf16, "model",
         True, 0, "mma"),
        # 16 chunks: a long look-back chain
        ("long S4096 bf16", 2, 4096, 80, 64, 1, 128, 256, bf16, "model",
         False, 0, "mma"),
        # x, b and c 2 elements (4 bytes) off TMA's 16-byte alignment
        ("misaligned +2 bf16", 2, 1024, 80, 64, 1, 128, 256, bf16, "model",
         False, 2, "fma"),
        # jamba-v0.1's Mamba layer: N 16, one 64-column box zero-filled
        ("jamba H128 P64 N16 bf16", 2, 1024, 128, 64, 1, 16, 256, bf16,
         "model", False, 0, "mma"),
        # chunks and a sequence shorter than one 64-row tile
        ("small P16 N16 G2 c16 S50 bf16", 2, 50, 4, 16, 2, 16, 16, bf16,
         "model", True, 0, "mma"),
        ("small P16 N8 G2 c16 S50 f32", 2, 50, 4, 16, 2, 8, 16, f32, "model",
         True, 0, "fma"),
    ]
    rows = {}
    for (name, bsz, s, h, p, g, n, chunk, dt_, decay, empty, off,
         want_variant) in cases:
        def rand(*shape, std=1.0):
            a = rng.standard_normal(shape, dtype=np.float32) * std
            return torch.from_numpy(a).to(dev)
        din = h * p
        # x, b and c as strided slices of one (B, S, off + din + 2 G N)
        # tensor, as the model's conv output
        xbc = torch.nn.functional.silu(
            rand(bsz, s, off + din + 2 * g * n)).to(dt_)
        x = xbc[..., off:off + din].reshape(bsz, s, h, p)
        b = xbc[..., off + din:off + din + g * n].reshape(bsz, s, g, n)
        c = xbc[..., off + din + g * n:].reshape(bsz, s, g, n)
        shift = 3.0 if decay == "strong" else 0.0
        dt = torch.nn.functional.softplus(rand(bsz, s, h) + shift)
        if empty:
            dt[:, ::7] = 0.0
            dt[:, s // 3: s // 3 + 100] = 0.0
        a = (torch.full((h,), -16.0, device=dev) if decay == "strong"
             else -torch.linspace(1.0, 16.0, h, device=dev))
        d = rand(h)
        pl = plan(bsz, s, h, p, g, n, chunk, dt_, sm_count(x.device),
                  aligned(x, b, c))
        check(pl.variant == want_variant,
              f"ssd {name}: plan picked {pl.variant}, want {want_variant}")
        check(library_smem_bytes(pl, n) == pl.smem,
              f"ssd {name}: the plan's shared memory {pl.smem} is not the "
              f"kernel's {library_smem_bytes(pl, n)}")
        reset_counts()
        out = ssd_scan_bshp(x, dt, a, b, c, d, chunk=chunk)
        again = ssd_scan_bshp(x, dt, a, b, c, d, chunk=chunk)
        want = ssd_chunked_ref(x, dt, a, b, c, d, chunk=chunk)
        oracle = ssd_oracle(x.float(), dt, a, b.float(), c.float(), d)
        torch.cuda.synchronize()
        check(dict(ssd_scan_bshp.variants) == {want_variant: 2},
              f"ssd {name}: calls by variant {dict(ssd_scan_bshp.variants)}")
        check(torch.equal(out, again), f"ssd {name}: two calls differ")
        check(out.dtype == want.dtype and out.shape == want.shape,
              f"ssd {name}: {out.dtype}{tuple(out.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        check(bool(torch.isfinite(out).all()), f"ssd {name}: not finite")
        err, rel = _slice_scaled(out, want)
        err32, rel32 = _slice_scaled(out, oracle)
        tol, tol32 = SSD_TOL[dt_]
        check(rel <= tol,
              f"ssd {name}: slice-scaled error vs plain {rel} > {tol}")
        check(rel32 <= tol32, f"ssd {name}: slice-scaled error vs the f32 "
              f"oracle {rel32} > {tol32}")
        esz = x.element_size()
        bytes_moved = (esz * (2 * x.numel() + b.numel() + c.numel())
                       + 4 * (dt.numel() + a.numel() + d.numel()))
        flops = _ssd_flops(bsz, s, h, p, n, chunk)
        bound_ms, bound_by = _bound(bytes_moved, flops,
                                    BF16_FLOPS if dt_ == bf16 else F32_FLOPS)
        call = lambda: ssd_scan_bshp(x, dt, a, b, c, d,  # noqa: E731
                                     chunk=chunk)
        ms = time_cuda(call, flush)
        plain_ms = time_cuda(
            lambda: ssd_chunked_ref(x, dt, a, b, c, d, chunk=chunk), flush)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CUDA_ITERS):
            call()
        host_us = (time.perf_counter() - t0) / CUDA_ITERS * 1e6
        torch.cuda.synchronize()
        per_call = _kernels_per_call(call)
        # no single PyTorch call computes the SSD scan: library_ms null
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None, variant=pl.variant,
                          workspace_bytes=pl.workspace, host_us=host_us,
                          kernels_per_call=per_call)
        extra = ""
        if pl.variant == "mma":
            # the first design (fma) on the same inputs
            old = plan(bsz, s, h, p, g, n, chunk, dt_, sm_count(x.device),
                       variant="fma")
            old_out = run_plan(old, x, dt, a, b, c, d)
            torch.cuda.synchronize()
            _, old_rel = _slice_scaled(old_out, want)
            check(old_rel <= tol, f"ssd {name} fma: slice-scaled error "
                  f"{old_rel} > {tol}")
            was_ms = time_cuda(lambda: run_plan(old, x, dt, a, b, c, d),
                               flush)
            rows[name].update(was_ms=was_ms)
            extra = f" | fma (was) {was_ms * 1e3:.1f} us"
        print(f"[kernel] ssd_scan {name}: {pl.variant} (grid {pl.grid}, "
              f"{pl.waves:.2f} waves, {pl.hpb} heads and {pl.tiles} resident "
              f"tiles a block, {pl.smem} B shared, workspace "
              f"{pl.workspace / 1e6:.2f} MB); two calls "
              f"bit-equal | err={err:.3g} slice-scaled {rel:.3g} (tol "
              f"{tol:.3g}, margin {tol / max(rel, 1e-30):.2f}x), vs f32 "
              f"oracle err={err32:.3g} slice-scaled {rel32:.3g} (tol "
              f"{tol32:.3g}, margin {tol32 / max(rel32, 1e-30):.2f}x) | "
              f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}; "
              f"{flops / 1e9:.2f} GFLOP, {bytes_moved / 1e6:.2f} MB; "
              f"{100 * bound_ms / ms:.1f}% of bound, "
              f"{flops / ms / 1e9:.1f} TFLOP/s); host {host_us:.1f} us per "
              f"call; {per_call:g} CUDA kernels per call{extra}")
        del xbc, x, b, c, out, again, want, oracle
    del flush
    return rows


def devft_phase(arch, want_caps, per_kind, want_forward_layers,
                depth=None, seed: int = 0):
    """DevFT on ``arch`` at full width through the training entry point
    (the CLI's own spec resolution, then ``run_experiment``): four
    stages of one round each, capacities ``want_caps``, on the widths
    ``ARCH_CONFIGS`` holds, the depth cut to ``depth`` layers where given
    (the spec's config is cut, every width kept); ``per_kind`` maps each
    block kind to its wrappers' launches per layer per forward (the rest
    must launch none), and the run makes ``want_forward_layers``
    layer-forwards in all. Returns (launches by wrapper, the
    ``RunResult``, the run's base params, its config)."""
    import dataclasses

    from repro_torch.core import similarity_matrix
    from repro_torch.core.grouping import layer_vectors, spectral_grouping
    from repro_torch.experiments import run_experiment
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.federated import simulator
    from repro_torch.federated.client import make_local_train
    from repro_torch.federated.methods.devft import DevFT
    from repro_torch.interop import tree_map
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    tag = f"devft {arch}"
    argv = ["--arch", arch, "--full", "--method", "devft",
            "--rounds", "4", "--n-stages", "4", "--n-clients", "20",
            "--sample-frac", "0.1", "--k-local", "2", "--local-batch", "4",
            "--seq", "1024", "--lora-rank", "32", "--pretrain-steps", "0",
            "--seed", str(seed)]
    spec = train.spec_from_args(train.build_parser().parse_args(argv))
    cfg = spec.build_cfg()
    _check_config(arch, cfg)
    full_depth = cfg.n_layers
    build_cfg = ExperimentSpec.build_cfg
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    k, b, s = spec.k_local, spec.local_batch, spec.seq
    kinds = T.stack_kinds(cfg)

    # instrumentation, removed at the end: each stage's submodel build
    # (DGLG + DBLF on the card) and each client's K local steps, timed
    # with a synchronize on both sides; round 0's eval inputs, kept for
    # the reference-backend check
    stages, evals, base = [], [], {}

    def timed_on_stage(self, state, stage):
        if stages:
            stages[-1]["peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        on_stage(self, state, stage)
        torch.cuda.synchronize()
        sub = state["sub"]
        stages.append(dict(stage=stage, capacity=sub.capacity,
                           sizes=T.stack_sizes(sub.params["blocks"]),
                           build_s=time.perf_counter() - t0,
                           plan={n: p["groups"] for n, p in sub.plan.items()},
                           lora_in=tree_map(lambda t: t.cpu(), state["lora"]),
                           params=state["params"], local_s=[]))

    def timed_make_local(sub_cfg, **kw):
        local = make_local(sub_cfg, **kw)

        def run(*a, **kw2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = local(*a, **kw2)
            torch.cuda.synchronize()
            stages[-1]["local_s"].append(time.perf_counter() - t0)
            return out
        return run

    def kept_eval(self, cfg_, params, lora, batch):
        out = ev(self, cfg_, params, lora, batch)
        if not evals:
            evals.append((cfg_, params, lora, batch, out))
            base["params"] = self.params
        return out

    on_stage, make_local, ev = (DevFT.on_stage, simulator.make_local_train,
                                simulator.FederatedRunner._eval)
    patches = [(DevFT, "on_stage", timed_on_stage),
               (simulator, "make_local_train", timed_make_local),
               (simulator.FederatedRunner, "_eval", kept_eval)]
    if depth:
        patches.append((ExperimentSpec, "build_cfg",
                        lambda self: dataclasses.replace(build_cfg(self),
                                                         n_layers=depth)))
    kernels = _path_kernels()
    with _patched(*patches):
        _reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = run_experiment(spec, device="cuda", dtype=torch.bfloat16,
                                round_progress=lambda log: print(
                                    f"[{tag}] round {log.round} stage "
                                    f"{log.stage} cap {log.capacity:2d} "
                                    f"eval loss {log.eval_loss:.4f} acc "
                                    f"{log.eval_acc:.4f} up "
                                    f"{log.comm_bytes_up / 1e6:.2f} MB "
                                    f"flops {log.flops:.3g}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages[-1]["peak"] = torch.cuda.max_memory_allocated()
        launches = {fn.__name__: fn.launches for fn in kernels}

    caps = [st["capacity"] for st in stages]
    check(caps == want_caps, f"{tag}: stage capacities {caps}")
    check([log.capacity for log in result.logs] == caps,
          f"{tag}: round capacities {[log.capacity for log in result.logs]}")
    n_clients = max(1, int(spec.n_clients * spec.sample_frac))
    # every forward runs each kernel of a layer per_kind[kind] times per
    # layer of that kind (lora_matmul twice: W_q and W_v, in_proj and
    # out_proj, or W_q_b and W_kv_b): n_clients x K local steps and one
    # eval per round, one round per stage; the backward and DGLG/DBLF
    # launch none
    want = {fn.__name__: 0 for fn in kernels}
    forwards_layers = want_bwd = 0
    for st in stages:
        for name, n in st["sizes"].items():
            forwards_layers += (n_clients * k + 1) * n
            for fn_name, per in per_kind.get(kinds[name], {}).items():
                want[fn_name] += (n_clients * k + 1) * n * per
            # the backward runs once a training forward's lora_matmul
            # (not the eval's)
            want_bwd += n_clients * k * n * per_kind.get(
                kinds[name], {}).get("lora_matmul_fused", 0)
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    _check_lora_bwd(tag, want_bwd)
    _check_lora_variants(kernels[1], tag)
    _check_flash_variant(kernels[2], tag, "mma_sync"
                         if cfg.attn_kind == "mla" else "wgmma")
    _check_ssd_variant(kernels[4], tag)
    _check_moe_variant(kernels[3], tag)
    check(forwards_layers == want_forward_layers,
          f"{tag}: {forwards_layers} forward layers")
    for log in result.logs:
        check(np.isfinite(log.eval_loss) and 0 <= log.eval_acc <= 1,
              f"{tag}: round {log.round}: eval {log.eval_loss} "
              f"{log.eval_acc}")
    check(all(bool(torch.isfinite(t).all())
              for t in _leaves(result.final_lora)),
          f"{tag}: non-finite final LoRA")
    cut = (f", DEPTH CUT to {depth} of {full_depth} layers (stacks "
           f"{dict(cfg.layer_stacks())}), widths unreduced" if depth else "")
    print(f"[{tag}] full width{cut}, bf16 params, rank-{spec.lora_rank} f32 "
          f"LoRA, {spec.rounds} rounds of {n_clients} clients x {k} local "
          f"steps x {b} x {s} tokens: wall {wall:.1f} s; launches "
          f"{launches}")
    for st in stages:
        t = st["local_s"]
        check(len(t) == n_clients, f"{tag}: stage {st['stage']}: {len(t)} "
              f"clients")
        step_ms = 1e3 * t[-1] / k
        print(f"[{tag}] stage {st['stage']} capacity {st['capacity']:2d} "
              f"(layers by stack {st['sizes']}): submodel build (DGLG + "
              f"DBLF) {st['build_s'] * 1e3:.1f} ms; local steps "
              f"{', '.join(f'{1e3 * x / k:.1f}' for x in t)} ms per step "
              f"(first client includes first use), {step_ms:.1f} ms per "
              f"step, {k * b * s / t[-1]:.0f} tokens/s; peak "
              f"{st['peak'] / 2**30:.2f} GiB")

    # one local step of the full model under the profiler
    full = stages[-1]["params"]
    lora = tree_map(lambda t: t.cuda(), stages[-1]["lora_in"])
    rng = np.random.default_rng(np.random.SeedSequence((seed, 8)))
    one = {key: rng.integers(0, cfg.vocab, (1, b, s), dtype=np.int32)
           for key in ("tokens", "labels")}
    local = make_local_train(cfg)
    local(full, lora, one, spec.lr)
    _profile(tag, f"one profiled local step at capacity {caps[-1]} "
             f"(forward, backward, AdamW)",
             lambda: local(full, lora, one, spec.lr))
    del lora

    # round 0's eval loss: through the kernels vs the plain versions
    cfg0, params0, lora0, batch0, (loss0, _) = evals[0]
    with torch.no_grad():
        _, m = T.loss_fn(dataclasses.replace(
            cfg0, kernel_backend="reference"), params0, lora0, batch0)
    plain = m["loss"]                    # the logged eval loss, aux apart
    rel = abs(loss0 - float(plain)) / abs(float(plain))
    check(loss0 == result.logs[0].eval_loss,
          f"{tag}: round 0 eval loss not logged")
    check(rel <= 1e-2, f"{tag}: round 0 eval loss: kernels {loss0} vs "
          f"plain {float(plain)} (rel {rel})")
    print(f"[{tag}] round 0 eval loss (capacity {caps[0]}, 16 x {s} "
          f"tokens): kernels {loss0:.5f}, plain versions {float(plain):.5f}, "
          f"rel diff {rel:.3g} (tol 1e-2)")
    del evals, params0, lora0, batch0, m

    # DGLG group lists of every stack a stage cut: the card's against the
    # CPU port's on the same tensors; a difference is reported with the
    # similarities, the Laplacian's eigen-gap, and the host clustering of
    # the card's own W (the clustering always runs on the host in f64,
    # and the layer vectors are an exact subsample, so only W's f32
    # rounding differs between the two)
    for st in stages[:-1]:
        for name, groups_card in st["plan"].items():
            n_groups = len(groups_card)
            if n_groups == T.stack_sizes(full["blocks"])[name]:
                continue                         # this stack was not cut
            lo_card = tree_map(lambda t: t.cuda(), st["lora_in"][name])
            vec = layer_vectors(full["blocks"][name], lo_card)
            w_card = similarity_matrix(vec).cpu()
            w_cpu = similarity_matrix(vec.cpu())
            del vec, lo_card
            seed_ = (spec.seed, st["stage"])
            groups = spectral_grouping(w_cpu, n_groups, seed=seed_)
            w = w_cpu.double().numpy().copy()
            np.fill_diagonal(w, 0.0)
            ev_ = np.linalg.eigvalsh(np.diag(w.sum(1)) - w)
            gap = ev_[n_groups] - ev_[n_groups - 1]
            same = groups == groups_card
            if not same:
                again = spectral_grouping(w_card, n_groups, seed=seed_)
                same_w = "equal to the card" if again == groups_card \
                    else again
                groups = (f"{groups} (host clustering of the card's W: "
                          f"{same_w})")
            print(f"[{tag}] stage {st['stage']} {name} groups (card) "
                  f"{groups_card}; CPU port {'equal' if same else groups}; "
                  f"max |W card - W cpu| "
                  f"{float((w_card - w_cpu).abs().max()):.3g}, W in "
                  f"[{float(w_cpu.min()):.4f}, {float(w_cpu.max()):.4f}], "
                  f"eigen-gap {gap:.3g} (eigenvalues "
                  f"{ev_[n_groups - 1]:.5g} and {ev_[n_groups]:.5g}, "
                  f"largest {ev_[-1]:.5g})")
    del stages, full
    return launches, result, base["params"], cfg


def _train_step_launches(cfg, n_enc=0):
    """One ``make_train_step`` step's launches (remat on, the step's
    default): the forward runs each layer once and the backward's
    recompute runs every layer that carries an adapter once more; the
    frozen encoder, which nothing needs a gradient of, is neither saved
    nor recomputed. ``lora_matmul`` on W_q and W_v, ``flash_attention``
    once a layer."""
    n = cfg.n_layers
    return {"flash_decode_bhrd": 0, "lora_matmul_fused": 2 * 2 * n,
            "flash_attention_bshd": 2 * n + n_enc, "moe_expert_ffn_ecd": 0,
            "ssd_scan_bshp": 0}


#: the remat policies the remat phase drives: none, whole blocks, and
#: the JAX package's dry-run's named policy (matmuls with no batch dims
#: kept, the attention products and the kernels recomputed)
REMAT_POLICIES = (False, True, "dots_with_no_batch_dims_saveable")
REMAT_STEPS = 3             # timed make_train_step steps after a warm-up
#: the LoRA gradients under a policy against remat=False: the recompute
#: runs the same deterministic kernels on the same inputs
REMAT_GRAD_TOL = 1e-6


def remat_phase(seed: int = 0):
    """Full-width llama2-7b-proxy, one ``make_train_step`` step (loss,
    LoRA gradients, AdamW) of 4 x 1024 tokens, the training phase's
    shapes, under each of ``REMAT_POLICIES``: ms per step (the median of
    ``REMAT_STEPS`` warm steps), peak memory, exact launches (the
    recompute runs every kernel again under a policy that checkpoints),
    and the one-card dry-run's predicted peak and FLOPs for the same step
    on meta tensors beside them. The loss must be bit-equal across the
    policies and the LoRA gradients within ``REMAT_GRAD_TOL`` of the
    norm."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data.synthetic import (client_round_batches,
                                            make_federated_data)
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import init_adamw

    cfg = get_config("llama2-7b-proxy")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab, cfg.dtype) == LLAMA_SHAPE,
          f"llama2-7b-proxy config changed: {cfg}")
    batch_size, seq, rank, lr = 4, 1024, 32, 1e-4
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, g)
    lora = _nonzero_lora(T, cfg, g, rank, 0.02)
    data = make_federated_data(cfg.vocab, n_clients=20, seed=seed)
    b = client_round_batches(data, [0], 1, batch_size, seq, (seed, 0))
    batch = {k: torch.as_tensor(v[0, 0]).cuda() for k, v in b.items()}
    opt = init_adamw(lora)
    shape = InputShape("chip 4x1024", seq, batch_size, "train")
    kernels = _path_kernels()
    n = cfg.n_layers
    base = None
    for remat in REMAT_POLICIES:
        t0 = time.perf_counter()
        fn, args = dryrun.build_cfg(cfg, shape, rank=rank, remat=remat)
        pred = dryrun.measure(fn, args)
        pred_peak = (pred["argument_size_in_bytes"]
                     + pred["temp_size_in_bytes"])
        dry_s = time.perf_counter() - t0
        total, _m, grads = T.loss_and_lora_grads(cfg, params, lora, batch,
                                                 remat=remat)
        step = make_train_step(cfg, remat=remat)
        step(params, lora, opt, batch, lr)              # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(REMAT_STEPS):
            _reset_all_counts()
            t0 = time.perf_counter()
            new_lora, _opt, metrics = step(params, lora, opt, batch, lr)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            again = 1 if remat is False else 2
            want = {fn.__name__: 0 for fn in kernels}
            want["lora_matmul_fused"] = 2 * n * again
            want["flash_attention_bshd"] = n * again
            launches = {fn.__name__: fn.launches for fn in kernels}
            check(launches == want, f"remat {remat!r}: launches {launches}, "
                  f"want {want}")
            _check_lora_variants(kernels[1], f"remat {remat!r}")
            _check_flash_variant(kernels[2], f"remat {remat!r}")
        peak = torch.cuda.max_memory_allocated()
        ms = float(np.median(walls)) * 1e3
        check(np.isfinite(float(metrics["loss"])),
              f"remat {remat!r}: loss {metrics['loss']}")
        gl = _leaves(grads)
        if base is None:
            base = (total, gl)
            worst = 0.0
        else:
            check(torch.equal(total, base[0]),
                  f"remat {remat!r}: loss {float(total)!r} is not "
                  f"remat=False's {float(base[0])!r}")
            worst = max(float(torch.linalg.vector_norm(x - y)
                              / torch.linalg.vector_norm(y))
                        for x, y in zip(gl, base[1]))
            check(worst <= REMAT_GRAD_TOL,
                  f"remat {remat!r}: LoRA gradients {worst:.3g} of their "
                  f"norm from remat=False's (limit {REMAT_GRAD_TOL})")
        print(f"[remat] llama2-7b-proxy full width, B{batch_size} S{seq}, "
              f"remat={remat!r}: {ms:.1f} ms per step (median of "
              f"{REMAT_STEPS}: {', '.join(f'{w * 1e3:.1f}' for w in walls)}"
              f"), peak {peak / 2**30:.2f} GiB; launches {launches}; loss "
              f"{float(total):.6f} (bit-equal), LoRA gradients "
              f"{worst:.3g} of their norm from remat=False's")
        roof = dryrun.roofline_terms(pred["flops"], pred["bytes"],
                                     pred["dot_flops"])
        t_least = 1e3 * max(roof["t_compute"], roof["t_memory"])
        by_dtype = ", ".join(f"{k} {v / 1e12:.2f}"
                             for k, v in sorted(pred["dot_flops"].items()))
        print(f"[remat]   dry-run (meta, card path, {dry_s:.1f} s): peak "
              f"{pred_peak / 2**30:.2f} GiB (measured/predicted "
              f"{peak / pred_peak:.3f}), {pred['flops'] / 1e12:.2f} TFLOP "
              f"({by_dtype}), {pred['bytes'] / 1e12:.3f} TB; roofline "
              f"{roof['t_compute'] * 1e3:.1f} ms compute, "
              f"{roof['t_memory'] * 1e3:.1f} ms memory (measured/roofline "
              f"{ms / t_least:.2f})")
        del grads, new_lora, _opt, step
    _reset_all_counts()


def autotune_phase(seed: int = 0):
    """The four tunable kernels tuned at their path shapes into a
    temporary cache (default plan first, a strict improvement to replace
    it, clean L2 flushes), the cache written and read back, then every
    tuned call resolved through ``dispatch`` with the cache installed and
    held against its plain version at the kernel phases' limits."""
    import tempfile

    from repro_torch.kernels import autotune, dispatch

    t0 = time.perf_counter()
    before = dispatch.tuning_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cache = autotune.TuningCache(os.path.join(tmp, "tuning.json"))
        results = autotune.autotune(cache=cache, iters=20, seed=seed)
        cache.save()
        read = autotune.TuningCache.load(cache.path)
        check(read.data == cache.data, "the tuning cache did not round-trip")
        for r in results:
            print(f"[autotune] {r.kernel} {r.tag}: default "
                  f"{r.default} {r.default_us:.2f} us, tuned {r.config} "
                  f"{r.us:.2f} us ({r.default_us / r.us:.3f}x; "
                  f"{r.n_candidates} plans timed)")
        checked = autotune.verify_dispatch(read, seed=seed)
        _dispatch_host_cost(read, seed)
    check(dispatch.tuning_cache() is before,
          "the autotune phase left another tuning cache installed")
    check(len(checked) == len(results),
          f"dispatch checked {len(checked)} tuned calls of {len(results)}")
    for name, tag, cfg, err in checked:
        print(f"[autotune] dispatch {name} {tag} {cfg}: row-scaled error "
              f"{err:.3g} (limit {autotune.VERIFY_TOL[name]:.3g})")
    _reset_all_counts()
    print(f"[autotune] {len(results)} cases in "
          f"{time.perf_counter() - t0:.1f} s")


#: operands that stay f32 when a kernel's others are bf16 (the SSD's
#: step sizes, decay and skip, as the model feeds them)
F32_OPERANDS = {"ssd_scan": ("dt", "a", "d")}


def contracts_phase(seed: int = 0):
    """``repro_torch.analysis``'s contract layer on the card: C001 with
    every kernel's backends over its shape family on real tensors (the
    only place the hand kernels meet their declared contracts), C003 on
    the card's engines, C002 on meta tensors; zero findings; each
    wrapper's launches since the reset exactly its C001 cases x the two
    backends (``pallas``, ``auto``) that resolve to it. Then each hand
    kernel once at its family's first case, in f32 and in bf16, under
    ``guard_syncs("warn")``, printing the synchronizing calls it made."""
    from repro_torch.analysis import guard_syncs
    from repro_torch.analysis.contracts import shapes
    from repro_torch.analysis.contracts.kernels import check_kernels
    from repro_torch.analysis.contracts.serving import check_serving
    from repro_torch.analysis.contracts.strategies import check_strategies
    from repro_torch.kernels import dispatch

    t0 = time.perf_counter()
    contracts = dispatch.kernel_contracts()
    wrappers = {name: dispatch.get_kernel(name, "pallas", "cuda",
                                          tuned=False)
                for name in contracts}
    _reset_all_counts()
    findings, stats = check_kernels("cuda", seed)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in _path_kernels()}
    want = {fn.__name__: 2 * len(list(shapes.kernel_cases(
        contracts[name].family))) for name, fn in wrappers.items()}
    check(launches == want, f"[contracts] C001 launches {launches}, want "
          f"{want} (cases x pallas, auto)")
    t_c001 = time.perf_counter() - t0
    more, serve_stats = check_serving("cuda", seed)
    torch.cuda.synchronize()
    findings += more
    stats.update(serve_stats)
    t_c003 = time.perf_counter() - t0 - t_c001
    more, strategy_stats = check_strategies()
    findings += more
    stats.update(strategy_stats)
    check(not findings, "[contracts] findings:\n"
          + "\n".join(f.render() for f in findings))
    print(f"[contracts] {json.dumps(stats)}")
    print(f"[contracts] 0 findings; C001 launches {launches} (= cases x "
          f"2); C001 {t_c001:.1f} s, C003 {t_c003:.1f} s, C002 (meta) "
          f"{time.perf_counter() - t0 - t_c001 - t_c003:.1f} s")

    counts = {}
    for name, fn in sorted(wrappers.items()):
        tag, args, kwargs = next(shapes.kernel_cases(
            contracts[name].family, "cuda", seed))
        for dtype in (torch.float32, torch.bfloat16):
            cast = [a if k in F32_OPERANDS.get(name, ()) else a.to(dtype)
                    for k, a in args.items()]
            fn(*cast, **kwargs)                      # plan and workspace
            torch.cuda.synchronize()
            with guard_syncs("warn") as syncs:
                fn(*cast, **kwargs)
            torch.cuda.synchronize()
            counts[f"{fn.__name__} {tag} {str(dtype)[6:]}"] = syncs.count
    print(f"[contracts] synchronizing calls per wrapper call under "
          f"guard_syncs('warn'): {json.dumps(counts)}")
    _reset_all_counts()
    print(f"[contracts] phase {time.perf_counter() - t0:.1f} s")


def _dispatch_host_cost(cache, seed: int = 0):
    """Host time of one call at each path shape: the raw wrapper, then
    resolved through ``dispatch.get_kernel`` per call (as ``kernels.ops``
    does) with no tuning cache installed and with ``cache`` installed."""
    from repro_torch.kernels import autotune, dispatch

    dev = torch.device("cuda", 0)

    def host_us(fn, args, kwargs):
        for _ in range(3):
            fn(args, kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CUDA_ITERS):
            fn(args, kwargs)
        us = (time.perf_counter() - t0) / CUDA_ITERS * 1e6
        torch.cuda.synchronize()
        return us

    for name, tag, args, kwargs in autotune.path_cases(dev, seed):
        raw = dispatch.get_kernel(name, "auto", dev, tuned=False)
        times = {"raw": host_us(lambda a, k: raw(*a, **k), args, kwargs)}
        for what, installed in (("dispatch", None), ("tuned", cache)):
            previous = dispatch.set_tuning_cache(installed)
            try:
                times[what] = host_us(
                    lambda a, k: dispatch.get_kernel(name, "auto", dev)(
                        *a, **k), args, kwargs)
            finally:
                dispatch.set_tuning_cache(previous)
        print(f"[autotune] host {name} {tag}: raw wrapper "
              f"{times['raw']:.1f} us, through dispatch "
              f"{times['dispatch']:.1f} us (no cache), "
              f"{times['tuned']:.1f} us (cache installed) per call")


def _kernels_vs_plain(tag, cfg, params, lora, batch):
    """Loss and every LoRA gradient through the kernels against the plain
    path (the ``reference`` backend) on the card, bf16, both with remat
    (the plain path's f32 attention probabilities at full depth would not
    fit otherwise). The loss is held within 1e-2 relative (the train
    parity phase's limit). The gradients are reported, not held: both
    paths run the same plain backward, so they differ only through the
    forward's bf16 roundings, which grow with depth (a leaf's difference
    reached 5.5% of its norm over qwen2-vl's 28 layers, 2.7% over
    whisper's 4 + 4, on the H100)."""
    import dataclasses

    from repro_torch.models import transformer as T

    kern = T.loss_and_lora_grads(cfg, params, lora, batch, remat=True)
    plain = T.loss_and_lora_grads(
        dataclasses.replace(cfg, kernel_backend="reference"), params, lora,
        batch, remat=True)
    rel = abs(float(kern[0]) - float(plain[0])) / abs(float(plain[0]))
    check(rel <= 1e-2, f"{tag}: loss through the kernels {float(kern[0])} "
          f"vs plain {float(plain[0])} (rel {rel})")
    diffs = [float((a - b).norm() / b.norm())
             for a, b in zip(_leaves(kern[2]), _leaves(plain[2]))]
    check(all(np.isfinite(diffs)), f"{tag}: gradients not finite")
    print(f"[{tag}] kernels vs the plain path on the card: loss "
          f"{float(kern[0]):.5f} vs {float(plain[0]):.5f} (rel {rel:.3g}, tol "
          f"1e-2); LoRA gradients differ by {np.median(diffs):.3g} of their "
          f"norms at the median, {max(diffs):.3g} at most, over "
          f"{len(diffs)} leaves (reported)")
    del kern, plain


#: the deepseek-v3-8l.devft cell's step at 3 dense + 1 MoE layers:
#: (layers, batch, sequence)
PUBLISHED_STEP = (4, 16, 512)


def deepseek_published_phase(seed: int = 0):
    """DeepSeek-V3 under its published rules (``published_deepseek``) at
    full width, 3 dense + 1 MoE layers, bf16, at the deepseek-v3-8l.devft
    cell's 16 x 512 tokens: one loss and LoRA gradients through the
    kernels under a profiler, with exact launches (``flash_attention``
    one a MLA layer, all ``mma_sync`` at D 192; ``lora_matmul`` two a
    layer; ``moe_expert_ffn`` one a MoE layer on the 8 held experts,
    ``wgmma`` with a fill), no slot dropped, and the held share of the
    routed slots printed beside its expectation of 8 / 256; then the
    loss through the kernels against the plain path (``_kernels_vs_plain``).
    Returns the launches."""
    from repro_torch.analysis import tracing
    from repro_torch.models import moe as Moe
    from repro_torch.models import transformer as T

    layers, b, s = PUBLISHED_STEP
    tag = "deepseek-v3 published step"
    cfg = published_deepseek(layers)
    n_moe = layers - cfg.moe.first_dense_layers
    check(Moe._capacity(cfg, b * s) >= b * s,
          f"{tag}: capacity {Moe._capacity(cfg, b * s)} drops slots")
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, g)
    _random_bias(params, g)
    lora = _nonzero_lora(T, cfg, g, 32, 0.02)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 29)))
    batch = {key: torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s), dtype=np.int32)).cuda()
        for key in ("tokens", "labels")}
    kernels = _path_kernels()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _reset_all_counts()
        tracing.reset_counters()
        t0 = time.perf_counter()
        loss, _, grads = T.loss_and_lora_grads(cfg, params, lora, batch)
        loss = float(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tracing.counters()
    launches = {fn.__name__: fn.launches for fn in kernels}
    want = {"flash_decode_bhrd": 0, "lora_matmul_fused": 2 * layers,
            "flash_attention_bshd": layers, "moe_expert_ffn_ecd": n_moe,
            "ssd_scan_bshp": 0}
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    _check_lora_variants(kernels[1], tag)
    _check_flash_variant(kernels[2], tag, "mma_sync")
    _check_moe_variant(kernels[3], tag)
    routed, held = counts["moe.routed_slots"], counts["moe.held_slots"]
    check(routed == n_moe * b * s * cfg.moe.top_k
          and counts["moe.dropped_slots"] == 0 and 0 < held < routed,
          f"{tag}: MoE slots {routed} routed, {held} held, "
          f"{counts['moe.dropped_slots']} dropped")
    check(np.isfinite(loss) and all(bool(torch.isfinite(t).all())
                                    for t in _leaves(grads)),
          f"{tag}: loss or gradients not finite")
    print(f"[{tag}] {layers} layers ({n_moe} MoE), B{b} S{s} bf16: loss "
          f"{loss:.5f} and gradients in {wall:.2f} s (under the profiler); "
          f"launches {launches}; held slots {held} of {routed} routed "
          f"({100 * held / routed:.3f}%, expected 8/256 = 3.125% on "
          f"average), 0 dropped")
    del grads
    torch.cuda.empty_cache()
    _kernels_vs_plain(tag, cfg, params, lora, batch)
    del params, lora
    _reset_all_counts()
    torch.cuda.empty_cache()
    return launches


def vision_prefix_phase(params, cfg, lora, seed: int = 0):
    """qwen2-vl-7b at full width and depth with its vision prefix (the
    DevFT run's base params and final LoRA): 4 x (256 patches + 1024 text
    tokens), so every layer's attention runs at S1280. One
    ``make_train_step`` step through the kernels with exact launches
    (``_train_step_launches``; all on wgmma, unpadded), then a profiled
    one; the loss and LoRA gradients through the kernels against the
    plain path on the card. Returns the step's launches."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import init_adamw

    tag = "vision prefix qwen2-vl-7b"
    b, s, n_vis = 4, 1024, cfg.n_frontend_tokens
    rng = np.random.default_rng(np.random.SeedSequence((seed, 25)))
    batch = {key: torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s), dtype=np.int32)).cuda()
        for key in ("tokens", "labels")}
    batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
        (b, n_vis, cfg.d_model), dtype=np.float32)).cuda()
    step = make_train_step(cfg)
    opt = init_adamw(lora)
    kernels = _path_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    new_lora, _, metrics = step(params, lora, opt, batch, 1e-4)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    want = _train_step_launches(cfg)
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    _check_lora_variants(kernels[1], tag)
    _check_flash_variant(kernels[2], tag)
    check(np.isfinite(loss) and all(bool(torch.isfinite(t).all())
                                    for t in _leaves(new_lora)),
          f"{tag}: loss {loss} or the new LoRA not finite")
    print(f"[{tag}] full width, {cfg.n_layers} layers, B{b} x ({n_vis} "
          f"patches + {s} tokens): one train step {wall * 1e3:.1f} ms "
          f"(first at this shape), loss {loss:.4f}, launches {launches}, "
          f"max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del new_lora
    _profile(tag, "one profiled train step (forward, remat, backward, "
             "AdamW)", lambda: step(params, lora, opt, batch, 1e-4))
    _reset_all_counts()
    _kernels_vs_plain(tag, cfg, params, lora, batch)
    _reset_all_counts()
    return launches


WHISPER_STEPS = 3           # timed make_train_step steps after a warm-up


def whisper_phase(seed: int = 0):
    """whisper-tiny at full width (4 encoder and 4 decoder layers, d 384,
    6 heads of 64, vocab 51865), bf16 params, a rank-32 f32 LoRA on the
    decoder, 4 x (1500 audio frames + 448 tokens, the published decoder
    context): ``WHISPER_STEPS`` ``make_train_step`` steps after a warm-up,
    each with exact launches (``_train_step_launches``: the encoder's 4
    non-causal attentions once, the decoder twice), all on wgmma; one
    profiled step; the loss and LoRA gradients through the kernels
    against the plain path on the card; then DevFT's ``build_submodel``
    at capacities 1-4 on the card and on the CPU: the same groups (or,
    where they differ, the CPU's clustering of the card's own similarity
    matrix gives the card's), the encoder carried whole, the submodel's
    loss finite. Its serving is ``SERVE_ARCHS``'s. Returns a step's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import similarity_matrix
    from repro_torch.core.devft import build_submodel
    from repro_torch.core.grouping import layer_vectors, spectral_grouping
    from repro_torch.interop import tree_map
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import init_adamw

    tag = "whisper-tiny"
    cfg = get_config(tag)
    _check_config(tag, cfg)
    b, s, rank, lr = 4, 448, 32, 1e-4
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, g)
    lora = _nonzero_lora(T, cfg, g, rank, 0.02)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 26)))
    batch = {key: torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s), dtype=np.int32)).cuda()
        for key in ("tokens", "labels")}
    batch["audio_embeds"] = torch.from_numpy(rng.standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)).cuda()
    print(f"[{tag}] full width: "
          f"{sum(p.numel() for p in _leaves(params)) / 1e6:.2f} M params "
          f"({cfg.dtype}), stacks {T.stack_sizes(params['blocks'])}, "
          f"rank-{rank} f32 LoRA on {sorted(lora)}; B{b} x "
          f"({cfg.n_frontend_tokens} frames + {s} tokens)")

    step = make_train_step(cfg)
    kernels = _path_kernels()
    opt = init_adamw(lora)
    lora, opt, _ = step(params, lora, opt, batch, lr)         # warm-up
    want = _train_step_launches(cfg, n_enc=cfg.n_enc_layers)
    walls = []
    for _ in range(WHISPER_STEPS):
        _reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt, metrics = step(params, lora, opt, batch, lr)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in kernels}
        check(launches == want, f"{tag}: launches {launches}, want {want}")
        _check_lora_variants(kernels[1], tag)
        _check_flash_variant(kernels[2], tag)
        check(np.isfinite(loss), f"{tag}: loss {loss}")
    print(f"[{tag}] make_train_step x {WHISPER_STEPS} (after a warm-up): "
          f"{', '.join(f'{1e3 * w:.1f}' for w in walls)} ms, median "
          f"{1e3 * float(np.median(walls)):.1f} ms a step, "
          f"{b * (s + cfg.n_frontend_tokens) / float(np.median(walls)):.0f}"
          f" frames + tokens/s; last loss {loss:.4f}; launches a step "
          f"{launches}")
    _profile(tag, "one profiled train step (forward, remat, backward, "
             "AdamW)", lambda: step(params, lora, opt, batch, lr))
    _reset_all_counts()
    _kernels_vs_plain(tag, cfg, params, lora, batch)
    _reset_all_counts()

    cpu = [tree_map(lambda t: t.cpu(), tree) for tree in (params, lora)]
    for cap in (1, 2, 3, 4):
        seed_ = (seed, cap)
        sub = build_submodel(cfg, params, lora, cap, seed=seed_)
        sub_cpu = build_submodel(cfg, *cpu, cap, seed=seed_)
        groups, groups_cpu = sub.plan["dec"]["groups"], \
            sub_cpu.plan["dec"]["groups"]
        check(sub.params["blocks"]["enc"] is params["blocks"]["enc"]
              and "enc" not in sub.plan and sub.cfg.n_layers == cap,
              f"{tag}: capacity {cap}: the encoder not carried whole")
        note = "equal"
        if groups != groups_cpu:
            vec = layer_vectors(params["blocks"]["dec"], lora["dec"])
            again = spectral_grouping(similarity_matrix(vec).cpu(), cap,
                                      seed=seed_)
            check(again == groups, f"{tag}: capacity {cap}: groups card "
                  f"{groups}, CPU {groups_cpu}, CPU on the card's W {again}")
            note = (f"{groups_cpu} (the CPU's clustering of the card's own "
                    f"W gives the card's)")
        with torch.no_grad():
            sub_loss, _ = T.loss_fn(sub.cfg, sub.params, sub.lora, batch)
        check(bool(torch.isfinite(sub_loss)), f"{tag}: capacity {cap}: "
              f"submodel loss {float(sub_loss)}")
        print(f"[{tag}] build_submodel capacity {cap}: decoder groups (card) "
              f"{groups}; CPU {note}; encoder carried whole (the same "
              f"tensors); submodel loss {float(sub_loss):.4f}")
        del sub, sub_cpu
    _reset_all_counts()
    return launches


def devft_serve_phase(arch, result, params, cfg, per_step):
    """The train->serve hand-off on a DevFT run at full width: its final
    ``global`` adapter (``registry_from_run(..., personalize=False)``)
    served on the run's base params (``cfg`` the run's config, its depth
    cut where the run's was), 4 requests of 16 prompt and 8 generated
    tokens, with the serving phases' launch checks."""
    from repro_torch.interop import tree_paths
    from repro_torch.serving import ServingEngine, registry_from_run

    tag = f"devft serve {arch}"
    reg = registry_from_run(result, params, personalize=False)
    check(reg.ids() == ["global"], f"{tag}: registry ids {reg.ids()}")
    check(all(torch.equal(a, b) for a, b in zip(
        _leaves(reg.get("global")),
        [t for _, t in tree_paths(result.final_lora)])),
        f"{tag}: 'global' is not the final LoRA")
    n_slots, capacity = 4, 24
    engine = ServingEngine(cfg, params, adapters=reg, n_slots=n_slots,
                           kv_capacity=capacity)
    rng = np.random.default_rng(np.random.SeedSequence((0, 24)))
    prompts = [rng.integers(0, cfg.vocab, size=16, dtype=np.int32)
               for _ in range(4)]
    _reset_all_counts()
    engine.warmup()
    reqs = [engine.submit(p, max_new_tokens=8, adapter="global")
            for p in prompts]
    steps = 1                                            # the warm-up step
    t0 = time.perf_counter()
    while engine.has_work():
        engine.step()
        steps += 1
    wall = time.perf_counter() - t0
    launches = _check_serve_launches(
        tag, per_step, steps, fd_variant=_decode_variant(cfg, torch.bfloat16))
    held = _held_cases(cfg, n_slots, capacity, launches)
    for r in reqs:
        check(r.done and len(r.tokens) == 8
              and bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"{tag}: request {r.rid} tokens {r.tokens}")
    decode_times = [dt for r in reqs for dt in r.decode_times]
    print(f"[{tag}] the run's 'global' adapter (bit-equal to its final "
          f"LoRA) on its base params: 4 requests of 16 + 8 tokens in "
          f"{steps} engine steps, {wall:.2f} s; decode step p50 "
          f"{np.percentile(decode_times, 50) * 1e3:.2f} ms; launches "
          f"{ {k: v for k, v in launches.items() if v} or 'none'} at "
          f"shapes held in the kernel phase by {held or 'none'}; first "
          f"request {reqs[0].tokens.tolist()}")
    _reset_all_counts()


#: llama2-7b-proxy at full width, the shape the train phase checks
LLAMA_SHAPE = (32, 4096, 32, 32, 128, 11008, 32000, "bfloat16")


def _llama_spec(method, n_clients, sample_frac, seed):
    """The spec ``launch.train``'s own parser resolves for one round of
    ``method`` on full-width llama2-7b-proxy (2 sampled clients x K=2
    local steps of 4 x 1024 tokens, rank-32 LoRA, no pretraining)."""
    from repro_torch.launch import train

    argv = ["--arch", "llama2-7b-proxy", "--full", "--method", method,
            "--rounds", "1", "--n-clients", str(n_clients),
            "--sample-frac", str(sample_frac), "--k-local", "2",
            "--local-batch", "4", "--seq", "1024", "--lora-rank", "32",
            "--pretrain-steps", "0", "--seed", str(seed)]
    spec = train.spec_from_args(train.build_parser().parse_args(argv))
    cfg = spec.build_cfg()
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab, cfg.dtype) == LLAMA_SHAPE,
          f"llama2-7b-proxy config changed: {cfg}")
    return spec, cfg


def _path_kernels():
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.kernels.flash_decode import flash_decode_bhrd
    from repro_torch.kernels.lora_matmul import lora_matmul_fused
    from repro_torch.kernels.moe_ffn import moe_expert_ffn_ecd
    from repro_torch.kernels.ssd_scan import ssd_scan_bshp
    return (flash_decode_bhrd, lora_matmul_fused, flash_attention_bshd,
            moe_expert_ffn_ecd, ssd_scan_bshp)


def _reset_all_counts():
    """Zero the launch and variant counts of every kernel wrapper."""
    import importlib
    for name in ("flash_attention", "flash_decode", "lora_matmul",
                 "moe_ffn", "ssd_scan"):
        importlib.import_module(f"repro_torch.kernels.{name}").reset_counts()


@contextlib.contextmanager
def _patched(*patches):
    """Set ``owner.name = value`` for each ``(owner, name, value)`` while
    the block runs, then put back what was there (or nothing)."""
    saved = [(owner, name, owner.__dict__.get(name, _MISSING))
             for owner, name, _ in patches]
    for owner, name, value in patches:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value in saved:
            if value is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, value)


_MISSING = object()


def _check_training_round(tag, depth, forwards):
    """The launches since the last reset are one training round's at
    ``depth`` layers over ``forwards`` forwards (lora_matmul on W_q and
    W_v, flash_attention once a layer, all on their wgmma kernels,
    nothing else); then every count goes back to 0."""
    kernels = _path_kernels()
    want = {fn.__name__: 0 for fn in kernels}
    want["lora_matmul_fused"] = 2 * depth * forwards
    want["flash_attention_bshd"] = depth * forwards
    launches = {fn.__name__: fn.launches for fn in kernels}
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    _check_lora_variants(kernels[1], tag)
    _check_flash_variant(kernels[2], tag)
    _reset_all_counts()
    return launches


#: the per-client bytes of rank-32 f32 LoRA on W_q and W_v of full-width
#: llama2-7b-proxy: 32 layers x 2 targets x (4096*32 + 32*4096) x 4 B
LLAMA_LORA_BYTES = 67_108_864


def methods_phase(seed: int = 0):
    """FLoRA, DoFIT, C2A and ProgFed on full-width llama2-7b-proxy,
    through ``sweep_cases`` on the card (one round each, ProgFed two
    stages of one), then ``aggregate_seeds``."""
    from repro_torch.core import make_schedule
    from repro_torch.experiments import aggregate_seeds, sweep_cases
    from repro_torch.federated import simulator
    from repro_torch.federated.methods.dofit import DoFIT
    from repro_torch.federated.methods.progfed import ProgFed
    from repro_torch.interop import tree_paths

    base, cfg = _llama_spec("fedit", 20, 0.1, seed)
    n_sample, k = max(1, int(base.n_clients * base.sample_frac)), \
        base.k_local
    tokens = k * base.local_batch * base.seq
    check(32 * 2 * (4096 * 32 + 32 * 4096) * 4 == LLAMA_LORA_BYTES,
          "LoRA bytes")
    cases = [{"method": "flora"}, {"method": "dofit"}, {"method": "c2a"},
             {"method": "progfed", "rounds": 2, "n_stages": 2}]

    # instrumentation, removed at the end: each client's K local steps
    # timed with a synchronize on both sides; DoFIT's SVD init timed,
    # with its tree and every SVD's singular values kept; ProgFed's
    # initial global LoRA kept to compare before finalize
    runs, svd_s = [], []
    make_local, svd = simulator.make_local_train, torch.linalg.svd
    dofit_init, pf_init, pf_finalize = (DoFIT.init_lora,
                                        ProgFed.init_state,
                                        ProgFed.finalize)

    def timed_make_local(sub_cfg, **kw):
        local = make_local(sub_cfg, **kw)

        def run(*a, **kw2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = local(*a, **kw2)
            torch.cuda.synchronize()
            runs[-1]["local_s"].append(time.perf_counter() - t0)
            return out
        return run

    def recording_svd(a, *args, **kw):
        out = svd(a, *args, **kw)
        svd_s.append(out[1][:, :base.lora_rank].clone())
        return out

    def timed_dofit_init(self, params, lora):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dofit_init(self, params, lora)
        torch.cuda.synchronize()
        runs[-1]["init_s"] = time.perf_counter() - t0
        runs[-1]["init"] = out
        return out

    def kept_init_state(self, params, lora):
        runs[-1]["lora0"] = [t.clone() for _, t in tree_paths(lora)]
        return pf_init(self, params, lora)

    def checked_finalize(self, state):
        runs[-1]["untouched"] = all(
            torch.equal(a, b) for a, b in
            zip(runs[-1]["lora0"], [t for _, t in tree_paths(
                state["lora"])]))
        return pf_finalize(self, state)

    def on_run(i, n, spec):
        _reset_all_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs.append(dict(method=spec.method, local_s=[], logs=[],
                         t0=time.perf_counter()))

    def on_round(log):
        run = runs[-1]
        tag = f"methods {run['method']} round {log.round}"
        _check_training_round(tag, log.capacity, n_sample * k + 1)
        run["logs"].append(log)
        run["peak"] = torch.cuda.max_memory_allocated()
        print(f"[methods] {run['method']} round {log.round} stage "
              f"{log.stage} cap {log.capacity} eval loss "
              f"{log.eval_loss:.4f} acc {log.eval_acc:.4f} up "
              f"{log.comm_bytes_up} B down {log.comm_bytes_down} B")

    with _patched((simulator, "make_local_train", timed_make_local),
                  (torch.linalg, "svd", recording_svd),
                  (DoFIT, "init_lora", timed_dofit_init),
                  (ProgFed, "init_state", kept_init_state),
                  (ProgFed, "finalize", checked_finalize)):
        t0 = time.perf_counter()
        results = sweep_cases(base, cases, device="cuda",
                              dtype=torch.bfloat16, progress=on_run,
                              round_progress=on_round)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    check([r.spec.method for r in results] == [c["method"] for c in cases],
          f"sweep order {[r.spec.method for r in results]}")
    by = {r.spec.method: (r, run) for r, run in zip(results, runs)}
    for method, (res, run) in by.items():
        check(len(run["logs"]) == len(res.logs) == res.spec.rounds,
              f"{method}: {len(res.logs)} rounds")
        for log in res.logs:
            check(np.isfinite(log.eval_loss) and 0 <= log.eval_acc <= 1,
                  f"{method} round {log.round}: eval {log.eval_loss}")
            per_client = LLAMA_LORA_BYTES * log.capacity // cfg.n_layers
            check(log.comm_bytes_up == log.comm_bytes_down
                  == n_sample * per_client,
                  f"{method} round {log.round}: up {log.comm_bytes_up} "
                  f"down {log.comm_bytes_down}, want {n_sample} x "
                  f"{per_client}")
        check(all(bool(torch.isfinite(t).all())
                  for t in _leaves(res.final_lora)),
              f"{method}: non-finite final LoRA")
    # FLoRA ships the full tree (its rank mask changes no byte count)
    check(by["flora"][0].logs[0].comm_bytes_up
          == n_sample * LLAMA_LORA_BYTES, "flora uplink")
    # C2A: B reset after the round
    for path, t in tree_paths(by["c2a"][0].final_lora):
        if path[-1] == "b":
            check(not bool(t.any()), f"c2a: {path} is not zero")
    # ProgFed: make_schedule's capacities; the initial LoRA untouched
    sched = make_schedule(cfg.n_layers, 2, 2, base.growth,
                          base.initial_capacity)
    pf_res, pf_run = by["progfed"]
    check([log.capacity for log in pf_res.logs] == sched.capacities
          == [16, 32], f"progfed capacities "
          f"{[log.capacity for log in pf_res.logs]} vs {sched.capacities}")
    check(pf_run.get("untouched") is True,
          "progfed: the initial global LoRA changed before finalize")
    # DoFIT: B zero at init, |A_col|^2 the top-r singular values. v is a
    # unit vector to f32 rounding: over 4096 elements at most n * 2**-24
    # = 2.4e-4 relative, typically a few 1e-6
    do_run = by["dofit"][1]
    init = do_run["init"]["layers"]
    check(len(svd_s) == 2, f"{len(svd_s)} batched SVDs")
    worst = 0.0
    for t, s in zip(init, svd_s):
        check(not bool(init[t]["b"].any()), f"dofit: {t} B not zero")
        a = init[t]["a"].double()
        rel = ((a * a).sum(1) - s.double()).abs() / s.double()
        worst = max(worst, float(rel.max()))
    check(worst <= 2.4e-4, f"dofit: |A_col|^2 vs s rel {worst}")

    folded = aggregate_seeds(results)
    check([f["spec"].method for f in folded] == [c["method"] for c in cases]
          and all(f["n_seeds"] == 1 for f in folded),
          "aggregate_seeds grouping")
    print(f"[methods] llama2-7b-proxy full width, bf16 params, rank-"
          f"{base.lora_rank} f32 LoRA, {n_sample} clients x {k} local "
          f"steps x {base.local_batch} x {base.seq} tokens; sweep of "
          f"{len(results)} runs in {wall:.1f} s")
    print(f"[methods] dofit: SVD init of {sum(s.shape[0] for s in svd_s)} "
          f"f32 {cfg.d_model} x {cfg.d_model} weights (W_q, W_v; cuSOLVER "
          f"gesvd) {do_run['init_s']:.2f} s on the card; B zero; max rel "
          f"| |A_col|^2 - s | {worst:.3g} (tol 2.4e-4)")
    for f, (res, run) in zip(folded, zip(results, runs)):
        t = run["local_s"]
        step_ms = 1e3 * t[-1] / k
        print(f"[methods] {res.spec.method}: local steps "
              f"{', '.join(f'{1e3 * x / k:.1f}' for x in t)} ms per step; "
              f"{step_ms:.1f} ms per step (last client), "
              f"{tokens / t[-1]:.0f} tokens/s; peak "
              f"{run['peak'] / 2**30:.2f} GiB; run wall "
              f"{res.wall_s:.1f} s; final eval loss "
              f"{f['metrics']['final_loss']['mean']}; up "
              f"{sum(log.comm_bytes_up for log in res.logs)} B")
    print(f"[methods] progfed: capacities {sched.capacities} "
          f"(make_schedule), initial global LoRA bit-identical before "
          f"finalize; c2a: every B zero after the round; flora: "
          f"{LLAMA_LORA_BYTES} B a client up and down")
    return results


def handoff_phase(seed: int = 0):
    """One FedSA round on full-width llama2-7b-proxy with the train->serve
    export, the final LoRA's checkpoint round trip on the card, the
    exported registry served at full width, and the public
    ``kv_cache.flash_decode`` helper at the serve shape."""
    from repro_torch import checkpoint
    from repro_torch.experiments import run_experiment
    from repro_torch.interop import tree_paths
    from repro_torch.kernels import ref
    from repro_torch.serving import ServingEngine, adapters, kv_cache

    spec, cfg = _llama_spec("fedsa", 4, 0.5, seed)
    n_sample, k = max(1, int(spec.n_clients * spec.sample_frac)), \
        spec.k_local
    flash_decode_bhrd = _path_kernels()[0]

    kept = {}
    personalize = adapters.personalized_adapters

    def timed_personalize(result, params, data=None, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = personalize(result, params, data, **kw)
        torch.cuda.synchronize()
        kept.update(params=params, wall=time.perf_counter() - t0)
        kept["launches"] = _check_training_round(
            "handoff personalization", cfg.n_layers, spec.n_clients * k)
        return out

    def on_round(log):
        _check_training_round(f"handoff fedsa round {log.round}",
                              log.capacity, n_sample * k + 1)
        check(log.comm_bytes_up == n_sample * LLAMA_LORA_BYTES // 2
              and log.comm_bytes_down == n_sample * LLAMA_LORA_BYTES,
              f"fedsa bytes up {log.comm_bytes_up} down "
              f"{log.comm_bytes_down}")
        print(f"[handoff] fedsa round {log.round}: eval loss "
              f"{log.eval_loss:.4f}, up {log.comm_bytes_up // n_sample} B "
              f"a client (A only), down {log.comm_bytes_down // n_sample} "
              f"B")

    _reset_all_counts()
    with _patched((adapters, "personalized_adapters", timed_personalize)):
        t0 = time.perf_counter()
        result = run_experiment(spec, export_adapters=True, device="cuda",
                                dtype=torch.bfloat16,
                                round_progress=on_round)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    reg = result.adapter_registry
    ids = [f"client/{c}" for c in range(spec.n_clients)]
    check(sorted(reg.ids()) == sorted(ids + ["global"]),
          f"registry ids {reg.ids()}")
    final = [t for _, t in tree_paths(result.final_lora)]
    check(all(torch.equal(a, b) for a, b in
              zip(_leaves(reg.get("global")), final)),
          "registry 'global' is not the final LoRA")
    for i in ids:
        check(not all(torch.equal(a, b) for a, b in
                      zip(_leaves(reg.get(i)), final)),
              f"{i} equals the global adapter")
    print(f"[handoff] run_experiment(export_adapters=True): {wall:.1f} s, "
          f"of which personalization {kept['wall']:.2f} s "
          f"({spec.n_clients} clients x {k} local steps: "
          f"{1e3 * kept['wall'] / (spec.n_clients * k):.1f} ms a step); "
          f"registry {sorted(reg.ids())}")

    # checkpoint round trip of {"lora": final LoRA} on the card
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    path = os.path.join(root, "handoff.ckpt")
    tree = {"lora": result.final_lora}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, tree)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    back = checkpoint.restore(path, tree)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    os.remove(path)
    for (p, a), (_, b) in zip(tree_paths(tree), tree_paths(back)):
        check(b.device == a.device and b.dtype == a.dtype
              and torch.equal(a, b), f"checkpoint {p} not bit-exact")
    print(f"[handoff] checkpoint {{'lora': final LoRA}}: {size} B, save "
          f"{save_s * 1e3:.1f} ms, restore to the card {restore_s * 1e3:.1f}"
          f" ms, bit-exact ({len(final)} leaves)")

    # serve the exported adapters at full width
    n_slots, capacity, n_req, gen_len = 8, 1024, 8, 32
    engine = ServingEngine(cfg, kept["params"], adapters=reg,
                           n_slots=n_slots, kv_capacity=capacity)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 21)))
    lens = rng.integers(16, 513, size=n_req)
    prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
               for n in lens]
    names = ["global"] + ids
    _reset_all_counts()
    t_warm = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t_warm
    reqs = [engine.submit(p, max_new_tokens=gen_len,
                          adapter=names[i % len(names)])
            for i, p in enumerate(prompts)]
    steps = 1                                            # the warm-up step
    t0 = time.perf_counter()
    while engine.has_work():
        engine.step()
        steps += 1
    wall = time.perf_counter() - t0
    launches = _check_serve_launches(
        "handoff serve", {"flash_decode_bhrd": cfg.n_layers}, steps)
    check(all(r.done for r in reqs), "not every request finished")
    for r in reqs:
        check(len(r.tokens) == gen_len
              and bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"request {r.rid}: tokens {r.tokens}")
    decode_times = [dt for r in reqs for dt in r.decode_times]
    ttft = [r.ttft_s for r in reqs]
    n_new = sum(len(r.generated) for r in reqs)
    print(f"[handoff] served {n_req} requests on {len(names)} exported "
          f"adapters, prompts {int(lens.min())}-{int(lens.max())}, gen "
          f"{gen_len}, {n_slots} slots, capacity {capacity}: engine steps "
          f"{steps} (warm-up {warm_s:.2f} s), flash_decode launches "
          f"{launches['flash_decode_bhrd']} = {cfg.n_layers} x {steps}, all "
          f"tma_mma; lora_matmul and flash_attention 0")
    print(f"[handoff] TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms | "
          f"decode step p50 {np.percentile(decode_times, 50) * 1e3:.2f} ms "
          f"p99 {np.percentile(decode_times, 99) * 1e3:.2f} ms "
          f"({len(decode_times)} samples) | {n_new / wall:.1f} tok/s")
    del engine

    # the public helper at the serve shape: one launch, the plain
    # version's result within the kernel phase's limits
    h, hd = cfg.n_heads, cfg.hd
    q = torch.randn(n_slots, 1, h, hd, device="cuda").to(torch.bfloat16)
    kc = torch.randn(n_slots, capacity, cfg.n_kv_heads, hd,
                     device="cuda").to(torch.bfloat16)
    vc = torch.randn_like(kc)
    valid = torch.from_numpy(np.array(
        [capacity, 1, 0] + list(rng.integers(1, capacity + 1,
                                             size=n_slots - 3)),
        np.int32)).cuda()
    _reset_all_counts()
    got = kv_cache.flash_decode(q, kc, vc, kv_valid_len=valid,
                                backend="auto")
    plain = kv_cache.flash_decode(q, kc, vc, kv_valid_len=valid)
    want = ref.flash_decode_ref(q, kc, vc, kv_valid_len=valid)
    torch.cuda.synchronize()
    check(flash_decode_bhrd.launches == 1
          and dict(flash_decode_bhrd.variants) == {"tma_mma": 1},
          f"kv_cache.flash_decode: {flash_decode_bhrd.launches} launches "
          f"{dict(flash_decode_bhrd.variants)}")
    check(torch.equal(plain, want), "backend='reference' is not the plain "
          "version")
    live = valid > 0
    err, row = _row_scaled(got[live], want[live])
    tol = TOL[torch.bfloat16]
    check(err <= tol[0] and row <= tol[1]
          and not bool(got[~live].any()),
          f"kv_cache.flash_decode: err {err} row-scaled {row}, tol {tol}")
    print(f"[handoff] kv_cache.flash_decode(backend='auto') at B{n_slots} "
          f"C{capacity} H{h}/{cfg.n_kv_heads} D{hd} bf16: 1 launch "
          f"(tma_mma), max abs err {err:.3g}, row-scaled {row:.3g} "
          f"(tol {tol[0]}, {tol[1]:.3g}); empty slot exact zeros")
    _reset_all_counts()


#: every moe_expert_ffn shape (E, C, d, ff) the mesh phase's train steps
#: launch -> the kernel phase's case that holds it: the gather paths'
#: capacity 1280, ep's local capacity 2048
MESH_MOE = {(32, 1280, 1024, 512): MOE_PATH, (32, 2048, 1024, 512): MOE_EP}
MESH_STEPS = 3              # timed make_train_step steps after the first
#: the ep step's LoRA gradients through the kernels against the plain
#: path on the card: both run the same plain backward and differ by the
#: forward's bf16 roundings, which grow with depth (5.5% of a leaf's norm
#: over qwen2-vl's 28 layers, ``_kernels_vs_plain``; 7.3% at the median
#: and 9.5% at most over granite's 24 on the ep path, on an H100 80GB
#: HBM3 at 700 W, where the gather path's was 7.6% and 9.8%). So
#: ep's difference is held against the gather path's own on the same
#: step, the same roundings but for the expert buffers': at most
#: MESH_GRAD_RATIO times it, and never over MESH_GRAD_TOL of a norm. A
#: wrong expert offset, drop or combine differs by the whole norm. The
#: loss at the train parity phase's 1e-2 relative.
MESH_GRAD_RATIO = 1.5
MESH_GRAD_TOL = 0.25
ROUNDLOG_INTS = ("round", "stage", "capacity", "comm_bytes_up",
                 "comm_bytes_down", "memory_bytes", "n_dropped")
ROUNDLOG_FLOATS = ("eval_loss", "eval_acc", "flops", "sim_time_s")


def _same_run(a_logs, a_lora, b_logs, b_lora):
    """Whether two runs' RoundLog floats and final LoRA are the same
    bits (their integer fields are held apart)."""
    return all(getattr(a, f) == getattr(b, f) for a, b in zip(a_logs, b_logs)
               for f in ROUNDLOG_FLOATS) and all(
        torch.equal(x, y) for x, y in zip(_leaves(a_lora), _leaves(b_lora)))


def mesh_phase(none_run, seed: int = 0):
    """The multi-device slice on the card's only mesh, 1x1
    (``make_host_mesh`` on cuda: a world-1 ``nccl`` group): DevFT on
    full-width granite-moe-1b-a400m through ``run_experiment(spec.replace
    (mesh="host"))``, the spec the DevFT phase ran with ``mesh=None``,
    held against that run (``none_run``: spec, logs, final LoRA and base
    params on the host, launches): RoundLog integers exactly, floats and
    the final LoRA bit for bit, the same launches; then one
    ``make_train_step`` step of 4 x 1024 tokens on each MoE path
    (``gather``, ``gather_sharded``, ``ep``) on the mesh: launches,
    ``moe_expert_ffn``'s shapes (each held by a kernel-phase case),
    ``gather_sharded`` bit-equal to ``gather``, ``ep`` and ``gather``
    through the kernels against their plain paths, step times and peak
    memory. Returns the launches by run."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.experiments import run_experiment
    from repro_torch.interop import tree_map
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as Moe
    from repro_torch.optim.adamw import init_adamw

    spec, logs_none, lora_none, base, cfg, launches_none = none_run
    tag = "mesh"
    smi = nvidia_smi("name,power.limit")
    mesh = make_host_mesh("cuda")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and tuple(mesh.shape) == (1, 1)
              and mesh.mesh_dim_names == ("data", "model")
              and mesh.device_type == "cuda",
              f"{tag}: host mesh {mesh} on {dist.get_backend()}, world "
              f"{dist.get_world_size()}")
        print(f"[{tag}] host mesh {tuple(mesh.shape)} over "
              f"{mesh.mesh_dim_names} on a world-1 {dist.get_backend()} "
              f"group")
        kernels = _path_kernels()
        _reset_all_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        on = run_experiment(spec.replace(mesh="host"), device="cuda",
                            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {fn.__name__: fn.launches for fn in kernels}
        check(launches == launches_none, f"{tag}: devft launches {launches}"
              f", mesh=None {launches_none}")
        check(all(launches[n] for n in ("lora_matmul_fused",
                                        "flash_attention_bshd",
                                        "moe_expert_ffn_ecd")),
              f"{tag}: a kernel of the path did not launch: {launches}")
        _check_lora_variants(kernels[1], tag)
        _check_flash_variant(kernels[2], tag)
        _check_moe_variant(kernels[3], tag)
        check(len(on.logs) == len(logs_none) == 4,
              f"{tag}: {len(on.logs)} rounds")
        for a, b in zip(on.logs, logs_none):
            for f in ROUNDLOG_INTS:
                check(getattr(a, f) == getattr(b, f), f"{tag}: round "
                      f"{a.round} {f} {getattr(a, f)} vs {getattr(b, f)}")
        lora_on = tree_map(lambda t: t.cpu(), on.final_lora)
        if _same_run(on.logs, lora_on, logs_none, lora_none):
            held = "bit-equal to mesh=None (floats and final LoRA)"
        else:
            # a second mesh=None run says whether the card gives the same
            # bits twice; only if it does not are the floats held within
            # the train parity phase's limits
            again = run_experiment(spec, device="cuda", dtype=torch.bfloat16)
            lora_again = tree_map(lambda t: t.cpu(), again.final_lora)
            check(not _same_run(again.logs, lora_again, logs_none,
                                lora_none),
                  f"{tag}: two mesh=None runs are bit-equal but the mesh "
                  f"run is not")
            for a, b in zip(on.logs, logs_none):
                for f in ROUNDLOG_FLOATS:
                    x, y = getattr(a, f), getattr(b, f)
                    check(abs(x - y) <= 1e-2 * abs(y) + 1e-3,
                          f"{tag}: round {a.round} {f} {x} vs {y}")
            lim = 2 * spec.lr * spec.rounds * spec.k_local
            for x, y in zip(_leaves(lora_on), _leaves(lora_none)):
                check(float((x - y).abs().max()) <= lim,
                      f"{tag}: final LoRA beyond {lim}")
            held = ("NOT bit-equal, and two mesh=None runs are not either: "
                    "floats within 1e-2 relative + 1e-3, final LoRA within "
                    f"{lim:.3g}")
        print(f"[{tag}] devft granite-moe-1b-a400m on the 1x1 mesh (full "
              f"width, bf16 params placed as DTensors, the DevFT phase's "
              f"spec) on {smi}: wall {wall:.1f} s, peak "
              f"{peak / 2**30:.2f} GiB; "
              f"launches {launches} (= mesh=None's); RoundLog integers "
              f"equal, {held}; eval losses "
              f"{[round(log.eval_loss, 5) for log in on.logs]}")
        del on, lora_on
        out = {"devft granite-moe-1b-a400m on the 1x1 mesh": launches}

        # one train step on each MoE path
        params = tree_map(lambda t: t.cuda(), base)
        lora = tree_map(lambda t: t.cuda(), lora_none)
        opt = init_adamw(lora)
        rng = np.random.default_rng(np.random.SeedSequence((seed, 26)))
        b, s = spec.local_batch, spec.seq
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s),
                                                  dtype=np.int32)).cuda()
                 for k in ("tokens", "labels")}
        shapes, grads_seen = [], []
        ffn, adamw = Moe.ops.moe_expert_ffn, steps.adamw_update

        def recording_ffn(buf, wg, wu, wd, **kw):
            shapes.append((*buf.shape, wg.shape[2]))
            return ffn(buf, wg, wu, wd, **kw)

        def recording_adamw(grads, *a, **kw):
            grads_seen.append(grads)
            return adamw(grads, *a, **kw)

        n = cfg.n_layers
        want = {"flash_decode_bhrd": 0, "lora_matmul_fused": 2 * 2 * n,
                "flash_attention_bshd": 2 * n, "moe_expert_ffn_ecd": 2 * n,
                "ssd_scan_bshp": 0}
        res = {}
        with _patched((Moe.ops, "moe_expert_ffn", recording_ffn),
                      (steps, "adamw_update", recording_adamw)):
            for path in ("gather", "gather_sharded", "ep"):
                step = steps.make_train_step(cfg, moe_path=path, mesh=mesh)
                _reset_all_counts()
                shapes.clear()
                grads_seen.clear()
                new_lora, _, metrics = step(params, lora, opt, batch, spec.lr)
                torch.cuda.synchronize()
                got = {fn.__name__: fn.launches for fn in kernels}
                # remat (the step's default) runs each layer's forward
                # again in the backward: each kernel twice a layer
                check(got == want, f"{tag} {path}: launches {got}, want "
                      f"{want} (once per layer per forward, two forwards)")
                _check_lora_variants(kernels[1], f"{tag} {path}")
                _check_flash_variant(kernels[2], f"{tag} {path}")
                _check_moe_variant(kernels[3], f"{tag} {path}")
                held = sorted({MESH_MOE.get(tuple(sh), "none")
                               for sh in shapes})
                check("none" not in held and len(shapes) == 2 * n,
                      f"{tag} {path}: moe_expert_ffn shapes {set(shapes)}: "
                      f"no kernel-phase case holds one")
                times = []
                torch.cuda.reset_peak_memory_stats()
                for _ in range(MESH_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(params, lora, opt, batch, spec.lr)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                res[path] = dict(loss=metrics["loss"], grads=grads_seen[0],
                                 new_lora=new_lora, launches=got,
                                 ms=1e3 * float(np.median(times)),
                                 times=times, held=held,
                                 peak=torch.cuda.max_memory_allocated())
            check(torch.equal(res["gather_sharded"]["loss"],
                              res["gather"]["loss"])
                  and all(torch.equal(x, y) for x, y in zip(
                      _leaves((res["gather_sharded"]["grads"],
                               res["gather_sharded"]["new_lora"])),
                      _leaves((res["gather"]["grads"],
                               res["gather"]["new_lora"])))),
                  f"{tag}: the gather_sharded step differs from gather")
            # ep and gather through the kernels against their plain paths
            # on the card
            plain_cfg = dataclasses.replace(cfg, kernel_backend="reference")
            for path in ("ep", "gather"):
                step = steps.make_train_step(plain_cfg, moe_path=path,
                                             mesh=mesh)
                _reset_all_counts()
                grads_seen.clear()
                _, _, m_plain = step(params, lora, opt, batch, spec.lr)
                torch.cuda.synchronize()
                got = {fn.__name__: fn.launches for fn in kernels}
                check(not any(got.values()), f"{tag}: the plain {path} step "
                      f"launched {got}")
                r = res[path]
                r["plain_loss"] = float(m_plain["loss"])
                r["rel"] = abs(float(r["loss"]) - r["plain_loss"]) \
                    / abs(r["plain_loss"])
                r["diffs"] = [float((x - y).norm() / y.norm()) for x, y in
                              zip(_leaves(r["grads"]),
                                  _leaves(grads_seen[0]))]
                check(r["rel"] <= 1e-2, f"{tag} {path}: loss through the "
                      f"kernels {float(r['loss'])} vs plain "
                      f"{r['plain_loss']} (rel {r['rel']})")
                check(all(np.isfinite(r["diffs"])),
                      f"{tag} {path}: gradients not finite")
            del m_plain
        ep, gather = res["ep"], res["gather"]
        lim = min(MESH_GRAD_TOL, MESH_GRAD_RATIO * max(gather["diffs"]))
        check(max(ep["diffs"]) <= lim,
              f"{tag} ep: LoRA gradients differ from the plain path by "
              f"{ep['diffs']} of their norms (limit {lim:.3g}: "
              f"{MESH_GRAD_RATIO} x gather's {max(gather['diffs']):.3g}, at "
              f"most {MESH_GRAD_TOL})")
        for path, r in res.items():
            print(f"[{tag}] {path} train step on the 1x1 mesh (full-width "
                  f"granite, 4 x 1024 tokens, remat): loss "
                  f"{float(r['loss']):.5f}; launches {r['launches']}; "
                  f"moe_expert_ffn shapes held by {r['held']}; "
                  f"{r['ms']:.1f} ms per step (median of {MESH_STEPS}: "
                  f"{', '.join(f'{1e3 * t:.1f}' for t in r['times'])}), "
                  f"peak {r['peak'] / 2**30:.2f} GiB on {smi}")
        print(f"[{tag}] gather_sharded step bit-equal to gather (loss, LoRA "
              f"gradients, AdamW update)")
        for path, r in (("ep", ep), ("gather", gather)):
            print(f"[{tag}] {path} through the kernels vs its plain path on "
                  f"{smi}: loss {float(r['loss']):.5f} vs "
                  f"{r['plain_loss']:.5f} (rel {r['rel']:.3g}, tol 1e-2), "
                  f"LoRA gradients differ by {np.median(r['diffs']):.3g} of "
                  f"their norms at the median, {max(r['diffs']):.3g} at most")
        print(f"[{tag}] ep's gradient difference held at {lim:.3g} "
              f"({MESH_GRAD_RATIO} x gather's, at most {MESH_GRAD_TOL}); ep "
              f"vs gather loss {float(ep['loss']):.5f} vs "
              f"{float(gather['loss']):.5f} (ep's local capacity 2048 "
              f"against gather's 1280)")
        out["granite ep train step on the 1x1 mesh"] = ep["launches"]
        del res, ep, gather, params, lora, opt
        return out
    finally:
        dist.destroy_process_group()


#: the DevFT phases, in order: (arch, stage capacities, launches per layer
#: per forward by block kind, layer-forwards in all, the depth trained
#: (None: the config's), the served global adapter's launches per engine
#: step)
_ATTN = {"lora_matmul_fused": 2, "flash_attention_bshd": 1}
_MAMBA = {"lora_matmul_fused": 2, "ssd_scan_bshp": 1}
DEVFT_RUNS = [
    ("granite-moe-1b-a400m", [3, 6, 12, 24],
     {"gqa_moe": dict(_ATTN, moe_expert_ffn_ecd=1)}, 225, None,
     SERVE_ARCHS["granite-moe-1b-a400m"][0]),
    ("mamba2-2.7b", [8, 16, 32, 64], {"mamba_only": _MAMBA}, 600, None,
     SERVE_ARCHS["mamba2-2.7b"][0]),
    # one interleave period (8 of 32 layers): stacks mamba_mlp / mamba_moe /
    # attn_mlp (1, 1, 1), (1, 1, 1), (2, 1, 1), (3, 4, 1); 25.6 GB in bf16
    ("jamba-v0.1-52b", [1, 2, 4, 8],
     {"mamba_mlp": _MAMBA, "mamba_moe": dict(_MAMBA, moe_expert_ffn_ecd=1),
      "gqa_mlp": _ATTN}, 90, 8,
     {"flash_decode_bhrd": 1, "moe_expert_ffn_ecd": 4}),
    # 4 of 61 layers, the 3 dense and 1 MoE (29.7 GB in bf16, 22.5 GB of
    # it the experts): stacks dense / moe (1, 1), (1, 1), (2, 1), (3, 1);
    # the MoE stack is never cut, so no stage copies its experts
    ("deepseek-v3-671b", [1, 2, 3, 4],
     {"mla_mlp": {"lora_matmul_fused": 2, "flash_attention_bshd": 1},
      "mla_moe": {"lora_matmul_fused": 2, "flash_attention_bshd": 1,
                  "moe_expert_ffn_ecd": 1}}, 55, 4,
     {"flash_decode_bhrd": 4, "moe_expert_ffn_ecd": 1}),
    # full depth, text-only batches as in the JAX package (15.2 GB in
    # bf16): capacities from capacity_schedule(28, 4); then the vision
    # prefix phase on the run's base params and final LoRA
    ("qwen2-vl-7b", [4, 7, 14, 28], {"gqa_mlp": _ATTN}, 265, None,
     SERVE_ARCHS["qwen2-vl-7b"][0]),
]


def _leaves(tree):
    from repro_torch.interop import tree_leaves
    return tree_leaves(tree)


#: the port's examples (``examples/torch_*.py``), driven by
#: ``examples_phase`` through their ``main(argv)``
EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples")
#: serve_adapter's adapter run against its merged run, row-scaled over the
#: live vocabulary: B is zero, so ``merge_lora`` adds exact zeros to W and
#: the adapter run adds exact zeros to x @ W; the limit is f32 summation
#: order only
EXAMPLE_MERGED_TOL = 1e-5
#: stage_anatomy's Eq. 5 check on the card (the CPU test holds 1e-6)
EXAMPLE_DBLF_TOL = 1e-5
#: the examples' kernel shapes, each held against its plain version in
#: f32 by a kernel-phase case (``examples_phase`` checks that every shape
#: it launches is here). lora_matmul (B, S, K, N, r) and flash_attention
#: (B, S, H, Hkv, D): quickstart's local steps (8 x 32 tokens) and evals
#: (16 x 32, ``EVAL_BATCH``), the ~100M run's (8 x 64 and 16 x 64);
#: W_q and W_v have the same N in both
EXAMPLE_LORA = {
    (8, 32, 256, 256, 8): "quickstart M256 K256 N256 r8 f32",
    (16, 32, 256, 256, 8): "quickstart eval M512 K256 N256 r8 f32",
    (8, 64, 512, 512, 16): "100M M512 K512 N512 r16 f32",
    (16, 64, 512, 512, 16): "100M eval M1024 K512 N512 r16 f32",
}
EXAMPLE_FLASH = {
    (8, 32, 4, 4, 64): "quickstart B8 S32 H4 D64 causal f32",
    (16, 32, 4, 4, 64): "quickstart eval B16 S32 H4 D64 causal f32",
    (8, 64, 8, 8, 64): "100M B8 S64 H8 D64 causal f32",
    (16, 64, 8, 8, 64): "100M eval B16 S64 H8 D64 causal f32",
}
#: serve_adapter's decode shapes over the reduced archs at batch 4 and 32
#: cache rows: flash_decode (B, H, Hkv, hd, vd, C), moe_expert_ffn (E, C,
#: d, ff)
EXAMPLE_DECODE = {
    (4, 4, 2, 64, 64, 32): "examples decode B4 C32 H4/2 hd64 f32",
    (4, 4, 4, 64, 64, 32): "examples decode B4 C32 H4/4 hd64 f32",
    (4, 4, 1, 48, 32, 32): "examples mla decode B4 C32 H4/1 hd48 vd32 f32",
}
EXAMPLE_MOE = {(4, 8, 256, 256): "examples decode E4 C8 d256 ff256 f32"}
#: the round engine's eval batch (``FederatedRunner.run``: 16 sequences)
EVAL_BATCH = 16


def _example(name):
    """``examples/<name>.py`` loaded as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_example_training(tag, runs):
    """The launches since the last reset are those of ``runs`` (dense
    llama-kind ``RunResult``s in f32): each round runs (sampled clients x
    K local steps + its eval) forwards of the round's capacity in layers,
    ``lora_matmul`` twice a layer (W_q, W_v) and ``flash_attention``
    once, all on their ``fma_f32`` variants unpadded, nothing else; then
    every count goes back to 0."""
    layer_forwards = train_forwards = 0
    for res in runs:
        spec, last = res.spec, len(res.logs) - 1
        clients = max(1, int(spec.n_clients * spec.sample_frac))
        for log in res.logs:
            evals = int(log.round % spec.eval_every == 0 or log.round == last)
            layer_forwards += (clients * spec.k_local + evals) * log.capacity
            train_forwards += clients * spec.k_local * log.capacity
    kernels = _path_kernels()
    launches = {fn.__name__: fn.launches for fn in kernels}
    want = {name: 0 for name in launches}
    want["lora_matmul_fused"] = 2 * layer_forwards
    want["flash_attention_bshd"] = layer_forwards
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    lm, fa = kernels[1], kernels[2]
    check(dict(lm.variants) == {"fma_f32": lm.launches} and lm.padded == 0,
          f"{tag}: lora_matmul variants {dict(lm.variants)}, padded "
          f"{lm.padded}")
    check(dict(fa.variants) == {"fma_f32": fa.launches},
          f"{tag}: flash_attention variants {dict(fa.variants)}")
    from repro_torch.kernels.lora_matmul import lora_matmul_bwd as bwd
    check(bwd.launches == 0 and bwd.plain == 2 * train_forwards,
          f"{tag}: lora_matmul_bwd launches {bwd.launches}, plain "
          f"{bwd.plain} (want 0 and {2 * train_forwards}: f32 keeps the "
          f"plain backward)")
    print(f"[{tag}] launches {launches} = {layer_forwards} layer-forwards "
          f"(derived from the RoundLogs), all on fma_f32, none padded; "
          f"{bwd.plain} lora_matmul backward calls, all plain f32")
    _reset_all_counts()
    return launches


def _held_training(tag, spec):
    """The kernel-phase cases at the shapes a run of ``spec`` (dense, f32)
    launches: its local steps' and its evals'; raises where no case holds
    one."""
    cfg = spec.build_cfg()
    held = []
    for b in (spec.local_batch, EVAL_BATCH):
        for key, table in (
                ((b, spec.seq, cfg.d_model, cfg.n_heads * cfg.hd,
                  spec.lora_rank), EXAMPLE_LORA),
                ((b, spec.seq, cfg.d_model, cfg.n_kv_heads * cfg.hd,
                  spec.lora_rank), EXAMPLE_LORA),
                ((b, spec.seq, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
                 EXAMPLE_FLASH)):
            check(key in table, f"{tag}: no kernel-phase case holds {key}")
            held.append(table[key])
    return sorted(set(held))


def _decode_launches(cfg):
    """One ``decode_step``'s launches: ``flash_decode`` once a layer of
    every kind that attends over a cache (GQA, MLA, the decoder's self-
    attention) and ``moe_expert_ffn`` once a MoE layer; Mamba mixers and
    the encoder launch none."""
    from repro_torch.models import transformer as T
    sizes = dict(cfg.layer_stacks())
    per = {"flash_decode_bhrd": 0, "moe_expert_ffn_ecd": 0}
    for name, kind in T.stack_kinds(cfg).items():
        if kind == "enc":
            continue
        if not kind.startswith("mamba"):
            per["flash_decode_bhrd"] += sizes[name]
        if kind.endswith("moe"):
            per["moe_expert_ffn_ecd"] += sizes[name]
    return per


def examples_phase():
    """The four examples (``examples/torch_*.py``) through their
    ``main(argv)`` on the card, in f32 as in the JAX package: quickstart
    (its preset's 12 rounds; launches derived from the RoundLogs; the
    integer books against the same run on the CPU; then ``--rounds 2``
    from a fresh interpreter), stage_anatomy (DBLF error, the broadcast,
    the card's groups beside the CPU port's on the same tensors),
    serve_adapter on every arch (launches per decode step derived from the
    config; adapter vs merged logits and tokens) and the ~100M DevFT-vs-
    FedIT run at its defaults. Returns each example's launches."""
    import collections
    import io

    from repro_torch.configs import ALL_ARCH_IDS, get_config, reduce_config
    from repro_torch.interop import tree_map
    from repro_torch.models.moe import _capacity

    t_phase = time.perf_counter()
    walls, launches = {}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        return out

    # quickstart: the preset on the card, then the same run on the CPU
    tag = "examples quickstart"
    qs = _example("torch_quickstart")
    _reset_all_counts()
    result = timed("quickstart", lambda: qs.main(["--device", "cuda"]))
    launches["quickstart"] = _check_example_training(tag, [result])
    print(f"[{tag}] shapes held in the kernel phases by "
          f"{_held_training(tag, result.spec)}")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = timed("quickstart on the CPU",
                    lambda: qs.run(qs.build_spec(), device="cpu"))
    books = [[getattr(log, f) for f in ROUNDLOG_INTS] for log in result.logs]
    check(books == [[getattr(log, f) for f in ROUNDLOG_INTS]
                    for log in cpu.logs],
          f"{tag}: integer books differ from the CPU run's")
    check(all(np.isfinite(log.eval_loss) for log in result.logs),
          f"{tag}: non-finite eval loss")
    print(f"[{tag}] {len(books)} rounds, capacities "
          f"{[log.capacity for log in result.logs]}: {ROUNDLOG_INTS} equal "
          f"to the CPU run's; final eval loss card "
          f"{result.logs[-1].eval_loss:.4f}, CPU {cpu.logs[-1].eval_loss:.4f} "
          f"(each device draws its own initial weights); wall card "
          f"{walls['quickstart']:.1f} s, CPU "
          f"{walls['quickstart on the CPU']:.1f} s")
    src = os.path.join(os.path.dirname(EXAMPLES_DIR), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable,
                          os.path.join(EXAMPLES_DIR, "torch_quickstart.py"),
                          "--rounds", "2"], capture_output=True, text=True,
                         env=env, timeout=300)
    walls["quickstart --rounds 2, fresh interpreter"] = \
        time.perf_counter() - t0
    check(out.returncode == 0 and "final loss" in out.stdout,
          f"{tag}: the script exited {out.returncode}: "
          f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    print(f"[{tag}] examples/torch_quickstart.py --rounds 2 in a fresh "
          f"interpreter: exit 0 in "
          f"{walls['quickstart --rounds 2, fresh interpreter']:.1f} s; "
          f"{out.stdout.strip().splitlines()[-1]}")

    # stage anatomy: W and the submodels on the card, then the CPU port's
    # groups on the same tensors
    tag = "examples stage_anatomy"
    sa = _example("torch_stage_anatomy")
    _reset_all_counts()
    card = timed("stage_anatomy", lambda: sa.main(["--device", "cuda"]))
    kernels = {fn.__name__: fn.launches for fn in _path_kernels()}
    check(not any(kernels.values()), f"{tag}: launches {kernels}")
    with contextlib.redirect_stdout(io.StringIO()):
        host = sa.anatomy(card["cfg"], tree_map(lambda t: t.cpu(),
                                                card["params"]),
                          tree_map(lambda t: t.cpu(), card["lora"]))
    w = host["w"].astype(np.float64)
    np.fill_diagonal(w, 0.0)
    eig = np.linalg.eigvalsh(np.diag(w.sum(1)) - w)
    off = w[~np.eye(len(w), dtype=bool)]
    w_diff = float(np.abs(card["w"] - host["w"]).max())
    for cap, st in card["stages"].items():
        check(st["dblf_err"] <= EXAMPLE_DBLF_TOL and st["broadcast"]
              and st["depth"] == cap,
              f"{tag}: capacity {cap}: DBLF error {st['dblf_err']}, "
              f"broadcast {st['broadcast']}, depth {st['depth']}")
        cpu_groups = host["stages"][cap]["groups"]
        same = st["groups"] == cpu_groups
        print(f"[{tag}] capacity {cap}: groups (card) {st['groups']}; CPU "
              f"port {'equal' if same else cpu_groups}; max |W card - W "
              f"cpu| {w_diff:.3g}; W off the diagonal in "
              f"[{off.min():.4f}, {off.max():.4f}]; eigen-gap "
              f"{eig[cap] - eig[cap - 1]:.3g}; DBLF max|err| "
              f"{st['dblf_err']:.2e} (tol {EXAMPLE_DBLF_TOL}); broadcast "
              f"correct")
    del card, host

    # serve_adapter on every arch: the adapter run, then the merged one
    sv = _example("torch_serve_adapter")
    launches["serve_adapter"] = collections.Counter()
    for arch in ALL_ARCH_IDS:
        tag = f"examples serve_adapter {arch}"
        cfg = reduce_config(get_config(arch))
        _reset_all_counts()
        out = timed(f"serve_adapter {arch}",
                    lambda: sv.main(["--arch", arch, "--device", "cuda"]))
        (t_a, tok_a, log_a), (t_m, tok_m, log_m) = \
            out["adapter"], out["merged"]
        steps = log_a.shape[1] + log_m.shape[1]
        per_step = _decode_launches(cfg)
        held = []
        if per_step["flash_decode_bhrd"]:
            # the cache holds the prompt and the generated tokens: one
            # row more than a run's steps
            shape = _decode_shape(cfg, tok_a.shape[0], log_a.shape[1] + 1)
            check(shape in EXAMPLE_DECODE, f"{tag}: no kernel-phase case "
                  f"holds flash_decode at {shape}")
            held.append(EXAMPLE_DECODE[shape])
        if per_step["moe_expert_ffn_ecd"]:
            shape = (cfg.moe.n_experts, _capacity(cfg, tok_a.shape[0]),
                     cfg.d_model, cfg.moe.d_ff_expert)
            check(shape in EXAMPLE_MOE, f"{tag}: no kernel-phase case "
                  f"holds moe_expert_ffn at {shape}")
            held.append(EXAMPLE_MOE[shape])
        launches["serve_adapter"].update(_check_serve_launches(
            tag, per_step, steps, torch.float32))
        _reset_all_counts()
        live = slice(0, cfg.vocab)
        check(bool(torch.isfinite(log_a[..., live]).all()),
              f"{tag}: non-finite logits")
        err, row = _row_scaled(log_a[..., live], log_m[..., live])
        check(row <= EXAMPLE_MERGED_TOL and torch.equal(tok_a, tok_m),
              f"{tag}: adapter vs merged logits row-scaled {row} (tol "
              f"{EXAMPLE_MERGED_TOL}), tokens equal "
              f"{torch.equal(tok_a, tok_m)}")
        print(f"[{tag}] per-token decode {t_a * 1e3:.2f} ms with adapter, "
              f"{t_m * 1e3:.2f} ms merged; {steps} steps, launches a step "
              f"{per_step}; adapter vs merged logits max abs {err:.3g}, "
              f"row-scaled {row:.3g} (tol {EXAMPLE_MERGED_TOL}), tokens "
              f"equal; wall {walls[f'serve_adapter {arch}']:.1f} s; shapes "
              f"held by {held or 'none'}")

    # the ~100M DevFT-vs-FedIT run at the example's defaults
    tag = "examples federated_100m"
    fed = _example("torch_federated_finetune_100m")
    _reset_all_counts()
    runs = timed("federated_finetune_100m",
                 lambda: fed.main(["--device", "cuda"]))
    launches["federated_100m"] = _check_example_training(tag, runs)
    print(f"[{tag}] shapes held in the kernel phases by "
          f"{_held_training(tag, runs[0].spec)}")
    res = {r.spec.method: fed.summary(r) for r in runs}
    check(sorted(res) == ["devft", "fedit"]
          and all(len(r["losses"]) == 30 and np.isfinite(r["losses"]).all()
                  for r in res.values()),
          f"{tag}: methods {sorted(res)}")
    with open(os.path.join("experiments", "examples",
                           "federated_100m_torch.json")) as f:
        check(json.load(f) == json.loads(json.dumps(res)),
              f"{tag}: the written JSON differs from the run")
    d, f_ = res["devft"], res["fedit"]
    comm_x, flops_x = f_["comm_MB"] / d["comm_MB"], f_["flops"] / d["flops"]
    check(comm_x > 1 and flops_x > 1,
          f"{tag}: DevFT saves comm x{comm_x}, flops x{flops_x}")
    for method, r in res.items():
        print(f"[{tag}] {method}: wall {r['wall_s']:.1f} s, final eval loss "
              f"{r['losses'][-1]:.4f}, comm {r['comm_MB']:.1f} MB, flops "
              f"{r['flops']:.4g}")
    print(f"[{tag}] DevFT vs FedIT: comm x{comm_x:.2f} less, flops "
          f"x{flops_x:.2f} less, final loss {d['losses'][-1]:.4f} vs "
          f"{f_['losses'][-1]:.4f}")
    print(f"[examples] walls (s): "
          f"{', '.join(f'{k} {v:.2f}' for k, v in walls.items())}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


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
    global HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS
    from repro_torch.kernels.common import H100_BF16_FLOPS as BF16_FLOPS
    from repro_torch.kernels.common import H100_F32_FLOPS as F32_FLOPS
    from repro_torch.kernels.common import \
        H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.kernels.flash_decode import flash_decode_bhrd
    from repro_torch.kernels.lora_matmul import lora_matmul_fused
    from repro_torch.kernels.moe_ffn import moe_expert_ffn_ecd
    from repro_torch.kernels.ssd_scan import ssd_scan_bshp
    from repro_torch.launch.env import setup_environment

    t_start = time.perf_counter()
    setup_environment("gpu")
    name, smi, build_s = device_phase(build)
    rows = kernel_phase(flash_decode_bhrd, ref.flash_decode_ref)
    lora_rows = lora_phase(lora_matmul_fused, ref.lora_matmul_ref)
    lora_bwd_rows = lora_bwd_phase()
    flash_rows = attention_phase(flash_attention_bshd,
                                 ref.attention_bshd_ref)
    moe_rows = moe_phase(moe_expert_ffn_ecd, ref.moe_expert_ffn_ref)
    ssd_rows = ssd_phase(ssd_scan_bshp, ref.ssd_scan_bshp_chunked_ref,
                         ref.ssd_scan_bshp_ref)
    autotune_phase()
    contracts_phase()
    serve_launches = {arch: serve_arch_phase(arch) for arch in SERVE_ARCHS}
    torch.cuda.empty_cache()
    parity_phase()
    prefill_vs_decode_phase()
    deepseek_published_phase()
    torch.cuda.empty_cache()
    train = train_phase()
    train_launches = train[-1]
    train_parity_phase(*train[:-1])
    del train
    torch.cuda.empty_cache()
    remat_phase()
    torch.cuda.empty_cache()
    path_steps = {"whisper-tiny train step": whisper_phase()}
    torch.cuda.empty_cache()
    methods_phase()
    torch.cuda.empty_cache()
    handoff_phase()
    torch.cuda.empty_cache()
    devft_launches = {}
    for arch, caps, per_kind, forward_layers, depth, per_step in DEVFT_RUNS:
        devft_launches[arch], result, base, cfg = devft_phase(
            arch, caps, per_kind, forward_layers, depth)
        devft_serve_phase(arch, result, base, cfg, per_step)
        if cfg.frontend == "vision":
            path_steps[f"{arch} vision-prefix train step"] = \
                vision_prefix_phase(base, cfg, result.final_lora)
        if arch == "granite-moe-1b-a400m":     # the mesh phase's reference
            from repro_torch.interop import tree_map
            granite_run = (result.spec, result.logs,
                           tree_map(lambda t: t.cpu(), result.final_lora),
                           tree_map(lambda t: t.cpu(), base), cfg,
                           devft_launches[arch])
        del result, base
        torch.cuda.empty_cache()
    path_steps.update(mesh_phase(granite_run))
    del granite_run
    torch.cuda.empty_cache()
    examples = examples_phase()
    torch.cuda.empty_cache()

    def cases(rows_, names, yardstick="library_ms"):
        """The new path shapes' numbers for the kernels line."""
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                yardstick, "variant")
        return {n: {k: rows_[n][k] for k in keys} for n in names}

    def example_launches(name):
        return {ex: n.get(name, 0) for ex, n in examples.items()}

    def path_launches(name):
        runs = {f"devft {arch}": n for arch, n in devft_launches.items()}
        return {tag: n[name] for tag, n in {**runs, **path_steps}.items()
                if n[name]}

    kernels = {"kernels": [
        dict(name="flash_decode", route="cuda",
             examples_launches=example_launches("flash_decode_bhrd"),
             source="src/repro_torch/kernels/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode.py:135",
             launches=serve_launches["qwen2-7b"][0], **rows[DECODE_PATH],
             serve_launches={a: n[0] for a, n in serve_launches.items()
                             if n[0]},
             cases=cases(rows, (DECODE_MLA, DECODE_MLA_DEVFT,
                                DECODE_JAMBA_DEVFT, DECODE_WHISPER,
                                DECODE_VL_DEVFT, *EXAMPLE_DECODE.values()))),
        dict(name="lora_matmul", route="cuda",
             examples_launches=example_launches("lora_matmul_fused"),
             source="src/repro_torch/kernels/csrc/lora_matmul.cu",
             replaces="src/repro/kernels/lora_matmul.py:94",
             launches=train_launches["lora_matmul_fused"],
             build_s=build_s["lora_matmul"], **lora_rows[LORA_PATH],
             path_launches=path_launches("lora_matmul_fused"),
             cases=cases(lora_rows, [n for n in lora_rows if n.startswith(
                 ("jamba", "deepseek", "qwen2-vl", "whisper", "quickstart",
                  "100M"))]),
             backward={n: lora_bwd_rows[n] for n in LORA_BWD_CELLS}),
        dict(name="flash_attention", route="cuda",
             examples_launches=example_launches("flash_attention_bshd"),
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:126",
             launches=train_launches["flash_attention_bshd"],
             **flash_rows[FLASH_PATH],
             path_launches=path_launches("flash_attention_bshd"),
             cases=cases(flash_rows, (FLASH_JAMBA, FLASH_WHISPER_ENC,
                                      FLASH_WHISPER_DEC, FLASH_VL,
                                      FLASH_VL_PREFIX,
                                      *EXAMPLE_FLASH.values()))),
        dict(name="moe_expert_ffn", route="cuda",
             examples_launches=example_launches("moe_expert_ffn_ecd"),
             source="src/repro_torch/kernels/csrc/moe_ffn.cu",
             replaces="src/repro/kernels/moe_ffn.py:92",
             launches=devft_launches["granite-moe-1b-a400m"][
                 "moe_expert_ffn_ecd"],
             **moe_rows[MOE_PATH],
             serve_launches={a: n[1] for a, n in serve_launches.items()
                             if n[1]},
             path_launches=path_launches("moe_expert_ffn_ecd"),
             cases=cases(moe_rows, (MOE_EP, MOE_JAMBA, MOE_DEEPSEEK,
                                    MOE_DECODE_DEEPSEEK,
                                    *EXAMPLE_MOE.values()), "bmm_ms")),
        dict(name="ssd_scan", route="cuda",
             examples_launches=example_launches("ssd_scan_bshp"),
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:105",
             launches=devft_launches["mamba2-2.7b"]["ssd_scan_bshp"],
             **ssd_rows[SSD_PATH],
             path_launches=path_launches("ssd_scan_bshp"),
             cases=cases(ssd_rows, (SSD_JAMBA,))),
    ]}
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
