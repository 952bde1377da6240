"""Plan autotuning for the Hopper kernels: the JAX package's
``repro.kernels.autotune``, over the knobs each kernel's ``plan`` already
takes.

Every kernel picks its plan with fixed rules (``lora_matmul``'s tile
width by waves, ``flash_decode``'s chunk by SMs, ...). This module times
the plans a shape allows on the card and keeps the fastest per (kernel,
shape) in a JSON tuning cache (``kernels.tuning``). ``dispatch.get_kernel``
hands a CUDA call on the ``pallas``/``auto`` backend the cached knobs,
but only from a cache installed on purpose: one that
``$REPRO_TORCH_TUNING_CACHE`` names or ``dispatch.set_tuning_cache``
installed. CPU tensors never reach the cache: they resolve to the plain
versions.

Design rules (the JAX package's, where they carry over):

* **The kernel's own plans only.** ``TUNABLES`` lists, per kernel, the
  values the ``.cu`` instantiates or takes at run time; each candidate
  goes through the kernel's ``plan`` with the knobs as overrides, and a
  candidate the plan refuses (shared memory, divisibility, a tiling no
  variant has) is dropped before timing. Candidates that give the same
  plan are timed once. No candidate is a new kernel design.
* **Never slower than the default.** ``DEFAULTS[name]`` is what ``plan``
  chooses for the shape (it depends on the shape); it is timed first,
  and a candidate replaces it only on a *strict* improvement.
* **Clean timing.** ``measure_us`` times with CUDA events, each call
  after an L2 flush that reads a buffer larger than L2 (a flush that
  writes it leaves dirty lines that the timed call would write back).
* **Checked before written.** The CLI resolves every winner through
  ``dispatch`` and holds it against the plain version
  (``verify_dispatch``) before it saves the cache; a failed check
  writes nothing.

``ssd_scan`` is not tunable, as in the JAX package: its chunk changes
the chunked recurrence's floating-point grouping (the numerics), not
only the schedule.

CLI (on the card; the cache is ``$REPRO_TORCH_TUNING_CACHE``, else
``build/repro_torch/tuning.json`` at the root of the checkout)::

    PYTHONPATH=src python -m repro_torch.kernels.autotune \\
        [--kernels lora_matmul,flash_decode] [--iters N] [--max-cases N] \\
        [--cache PATH]
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.tuning import (CACHE_ENV, TuningCache,  # noqa: F401
                                        default_cache_path, module,
                                        shape_key, source_hash)

#: candidate values per knob, per kernel (the product is filtered by each
#: kernel's ``plan``): the tilings, tile widths, chunks and ring depths
#: the kernels' sources instantiate or take at run time
TUNABLES: Dict[str, Dict[str, Tuple[int, ...]]] = {
    "lora_matmul": {"block_n": (64, 128, 256)},
    "moe_expert_ffn": {"block_n": (64, 128, 256)},
    "flash_attention": {"block_q": (32, 64, 128), "block_kv": (32, 64, 128),
                        "stages": (1, 2, 3, 4)},
    "flash_decode": {"chunk": (64, 128, 256, 512, 1024, 2048),
                     "stages": (1, 4, 5, 6, 7, 8)},
}

#: row-scaled error limits of a tuned call against its plain version, in
#: bf16 (``chip_smoke.py``'s kernel-phase limits)
VERIFY_TOL = {"lora_matmul": 2.0 ** -6, "moe_expert_ffn": 2.0 ** -6,
              "flash_attention": 2.0 ** -5, "flash_decode": 2.0 ** -5}

# ---------------------------------------------------------------------------
# plans and launches per kernel
# ---------------------------------------------------------------------------


def _n_sm(t: torch.Tensor) -> int:
    if t.is_cuda:
        from repro_torch.kernels.flash_decode import sm_count
        return sm_count(t.device)
    from repro_torch.kernels.lora_matmul import SMS
    return SMS


def _scale(kwargs: Dict, d: int) -> float:
    scale = kwargs.get("scale")
    return scale if scale is not None else 1.0 / math.sqrt(d)


def plan_for(name: str, args: Sequence, kwargs: Optional[Dict] = None,
             **knobs):
    """Kernel ``name``'s plan for a call on ``args``/``kwargs`` (the
    wrapper's), with ``knobs`` as overrides; raises where it refuses."""
    kwargs = kwargs or {}
    mod = module(name)
    if name == "lora_matmul":
        x, w, a, _b = args
        k, n = w.shape
        return mod.plan(x.numel() // k, k, n, a.shape[1], x.dtype, **knobs)
    if name == "moe_expert_ffn":
        buf, wg = args[:2]
        e, c, d = buf.shape
        return mod.plan(e, c, d, wg.shape[2], buf.dtype, **knobs)
    if name == "flash_attention":
        q, k = args[:2]
        b, s, h, d = q.shape
        return mod.plan(b, s, h, k.shape[2], d, q.dtype,
                        kwargs.get("causal", True), kwargs.get("window"),
                        positive_scale=_scale(kwargs, d) > 0, **knobs)
    if name == "flash_decode":
        q, k, v = args
        b, _, h, hd = q.shape
        return mod.plan(b, h, k.shape[2], k.shape[1], hd, v.shape[3],
                        q.dtype, k.dtype, _n_sm(q), **knobs)
    raise KeyError(f"kernel {name!r} is not tunable; tunable: "
                   f"{sorted(TUNABLES)}")


def _launcher(name: str, p, args: Sequence, kwargs: Dict) -> Callable:
    """One uncounted launch of plan ``p`` on the call's operands."""
    mod = module(name)
    if name == "lora_matmul":
        x, w, a, b = args
        x2 = x.reshape(-1, w.shape[0])
        scaling = kwargs.get("scaling", 1.0)
        return lambda: mod.run_plan(p, x2, w, a, b, scaling)
    if name == "moe_expert_ffn":
        return lambda: mod.run_plan(p, *args, kwargs.get("fill"))
    if name == "flash_attention":
        q = args[0]
        kw = dict(causal=kwargs.get("causal", True),
                  window=kwargs.get("window"),
                  scale=_scale(kwargs, q.shape[3]))
        return lambda: mod.run_plan(p, *args, **kw)
    q = args[0]
    return lambda: mod.run_plan(p, *args, kwargs["kv_valid_len"],
                                _scale(kwargs, q.shape[3]))


def _default(name: str, args: Sequence, kwargs: Optional[Dict] = None
             ) -> Dict[str, int]:
    return module(name).knobs(plan_for(name, args, kwargs))


#: kernel -> (args, kwargs) -> the knobs its ``plan`` chooses for them
DEFAULTS: Dict[str, Callable] = {name: functools.partial(_default, name)
                                 for name in TUNABLES}


def candidate_configs(name: str, args: Sequence,
                      kwargs: Optional[Dict] = None) -> List[Dict[str, int]]:
    """The default knobs first, then every ``TUNABLES`` combination the
    kernel's ``plan`` takes on this call, one per distinct plan."""
    default = DEFAULTS[name](args, kwargs)
    knobs = TUNABLES[name]
    combos = [default] + [dict(zip(knobs, values))
                          for values in itertools.product(*knobs.values())]
    seen, out = set(), []
    for cfg in combos:
        try:
            p = plan_for(name, args, kwargs, **cfg)
        except ValueError:
            continue
        if p in seen:
            continue
        seen.add(p)
        out.append(cfg)
    return out


# ---------------------------------------------------------------------------
# measurement + selection
# ---------------------------------------------------------------------------


def measure_us(fn: Callable, *, iters: int, flush: torch.Tensor,
               warmup: int = 3) -> float:
    """Median device time (µs) of one ``fn()`` call over ``iters`` calls,
    each bracketed by CUDA events after a clean L2 flush: ``flush`` (a
    buffer larger than L2) is read, which leaves no dirty line for the
    timed call to write back, and the stream is held busy so the events
    bracket the call's device work only."""
    for _ in range(max(1, warmup)):
        fn()
    times = []
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) * 1e3)
    return float(np.median(times))


@dataclasses.dataclass
class TuneResult:
    kernel: str
    tag: str
    key: str
    config: Dict[str, int]
    default: Dict[str, int]
    us: float
    default_us: float
    n_candidates: int

    @property
    def is_default(self) -> bool:
        return self.config == self.default


def tune_case(name: str, tag: str, args: Sequence, kwargs: Dict, *,
              iters: int = 20, measure: Optional[Callable] = None
              ) -> TuneResult:
    """Time every candidate plan of one call and keep the fastest. The
    default is timed first and a candidate replaces the incumbent only on
    a strict improvement, so ties and noise resolve to the default.
    ``measure(name, cfg, launch) -> µs`` replaces the card's timing (the
    tests inject one)."""
    if measure is None:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                            device=args[0].device)

        def measure(_name, _cfg, launch):
            return measure_us(launch, iters=iters, flush=flush)

    candidates = candidate_configs(name, args, kwargs)
    best_cfg: Optional[Dict[str, int]] = None
    best_us = default_us = 0.0
    for cfg in candidates:
        p = plan_for(name, args, kwargs, **cfg)
        us = measure(name, cfg, _launcher(name, p, args, kwargs))
        if best_cfg is None:
            best_cfg, best_us, default_us = cfg, us, us
        elif us < best_us:
            best_cfg, best_us = cfg, us
    return TuneResult(kernel=name, tag=tag, key=shape_key(name, args, kwargs),
                      config=best_cfg, default=candidates[0], us=best_us,
                      default_us=default_us, n_candidates=len(candidates))


# ---------------------------------------------------------------------------
# the path shapes (PERF.md § 6) and the tuning loop
# ---------------------------------------------------------------------------


def path_cases(device, seed: int = 0
               ) -> Iterator[Tuple[str, str, tuple, Dict]]:
    """(kernel, tag, args, kwargs) at the shapes the main paths give the
    tunable kernels, bf16, made from ``seed`` on ``device``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    bf = torch.bfloat16

    def rand(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(device, bf)

    for tag, m, k, n, r in (("llama W_q M4096 K4096 N4096 r32",
                             4096, 4096, 4096, 32),
                            ("granite W_q M4096 K1024 N1024 r32",
                             4096, 1024, 1024, 32),
                            ("qwen2-vl W_v M4096 K3584 N512 r32",
                             4096, 3584, 512, 32)):
        yield ("lora_matmul", tag,
               (rand(m, k), rand(k, n, std=k ** -0.5), rand(k, r, std=0.02),
                rand(r, n, std=0.02)), {"scaling": 2.0})
    for tag, h, hkv, d in (("llama B4 S1024 H32 D128 causal", 32, 32, 128),
                           ("granite B4 S1024 H16/8 D64 causal", 16, 8, 64)):
        yield ("flash_attention", tag,
               (rand(4, 1024, h, d), rand(4, 1024, hkv, d),
                rand(4, 1024, hkv, d)), {"causal": True, "window": None})
    yield ("moe_expert_ffn", "granite E32 C1280 d1024 ff512",
           (rand(32, 1280, 1024), rand(32, 1024, 512, std=1024 ** -0.5),
            rand(32, 1024, 512, std=1024 ** -0.5),
            rand(32, 512, 1024, std=512 ** -0.5)), {"fill": None})
    for tag, b, cap in (("qwen2-7b B8 C4096 H28/4 hd128", 8, 4096),
                        ("qwen2-7b serve B8 C1024 H28/4 hd128", 8, 1024)):
        valid = torch.randint(1, cap + 1, (b,), generator=gen,
                              dtype=torch.int32).to(device)
        yield ("flash_decode", tag,
               (rand(b, 1, 28, 128), rand(b, cap, 4, 128),
                rand(b, cap, 4, 128)), {"kv_valid_len": valid})


def autotune(kernels: Optional[Sequence[str]] = None, *,
             cache: Optional[TuningCache] = None, iters: int = 20,
             max_cases: Optional[int] = None, seed: int = 0,
             measure: Optional[Callable] = None) -> List[TuneResult]:
    """Tune every tunable kernel (or ``kernels``) at its path shapes on
    the current card; record the winners in ``cache``."""
    if not torch.cuda.is_available():
        raise RuntimeError("autotuning times the Hopper kernels: it needs "
                           "a CUDA card")
    device = torch.device("cuda", torch.cuda.current_device())
    device_name = torch.cuda.get_device_name(device)
    names = list(kernels) if kernels else sorted(TUNABLES)
    unknown = [n for n in names if n not in TUNABLES]
    if unknown:
        raise KeyError(f"not tunable: {unknown}; tunable: {sorted(TUNABLES)}")
    results: List[TuneResult] = []
    done: Dict[str, int] = {}
    for name, tag, args, kwargs in path_cases(device, seed):
        if name not in names or (max_cases is not None
                                 and done.get(name, 0) >= max_cases):
            continue
        done[name] = done.get(name, 0) + 1
        res = tune_case(name, tag, args, kwargs, iters=iters,
                        measure=measure)
        results.append(res)
        if cache is not None:
            cache.store(device_name, name, source_hash(name), res.key,
                        res.config, res.us, res.default_us)
    return results


def _row_scaled(got: torch.Tensor, want: torch.Tensor) -> float:
    diff = (got.float() - want.float()).abs().amax(-1)
    size = want.float().abs().amax(-1)
    return float(torch.where(size > 0, diff / size.clamp(min=1e-30),
                             diff * float("inf")).nan_to_num(0.0).max())


def verify_dispatch(cache: TuningCache, seed: int = 0) -> List[Tuple]:
    """Resolve every path case through ``dispatch`` with ``cache``
    installed: where the cache holds an entry, dispatch must hand the
    kernel exactly the stored knobs, and the tuned call must match the
    plain version within ``VERIFY_TOL``. Returns (kernel, tag, knobs,
    row-scaled error) per checked call; raises on any mismatch."""
    from repro_torch.kernels import dispatch

    device = torch.device("cuda", torch.cuda.current_device())
    device_name = torch.cuda.get_device_name(device)
    previous = dispatch.set_tuning_cache(cache)
    checked = []
    try:
        for name, tag, args, kwargs in path_cases(device, seed):
            key = shape_key(name, args, kwargs)
            want_cfg = cache.lookup(device_name, name, key,
                                    source_hash(name))
            if want_cfg is None:
                continue
            got_cfg = dispatch.tuned_config(name, args, kwargs)
            if got_cfg != want_cfg:
                raise AssertionError(
                    f"dispatch lookup for {name}[{key}] returned "
                    f"{got_cfg!r}, the cache holds {want_cfg!r}")
            got = dispatch.get_kernel(name, "auto", device)(*args, **kwargs)
            want = dispatch.get_kernel(name, "reference", device)(*args,
                                                                  **kwargs)
            err = _row_scaled(got, want)
            if not err <= VERIFY_TOL[name]:
                raise AssertionError(
                    f"{name} {tag} with {got_cfg}: row-scaled error {err} "
                    f"> {VERIFY_TOL[name]} against the plain version")
            checked.append((name, tag, got_cfg, err))
        return checked
    finally:
        dispatch.set_tuning_cache(previous)


def main(argv=None) -> int:
    import argparse

    from repro_torch.launch.env import setup_environment

    ap = argparse.ArgumentParser(
        description="time the Hopper kernels' plans at the path shapes; "
                    "keep the fastest in the device-keyed tuning cache")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated subset (default: all tunable)")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per candidate (after 3 warm-up "
                         "calls)")
    ap.add_argument("--max-cases", type=int, default=None,
                    help="limit the shape cases per kernel")
    ap.add_argument("--cache", default=None,
                    help=f"cache path (default ${CACHE_ENV} or "
                         f"build/repro_torch/tuning.json)")
    args = ap.parse_args(argv)
    setup_environment("gpu")
    cache = TuningCache.load(args.cache)
    names = args.kernels.split(",") if args.kernels else None
    results = autotune(names, cache=cache, iters=args.iters,
                       max_cases=args.max_cases)
    print(f"device={torch.cuda.get_device_name(0)}")
    print("kernel,shape,default_us,best_us,default,config,gain")
    for r in results:
        gain = "default" if r.is_default \
            else f"{r.default_us / r.us:.3f}x"
        fmt = (lambda c: ";".join(f"{k}={v}" for k, v in sorted(c.items())))
        print(f"{r.kernel},{r.tag},{r.default_us:.2f},{r.us:.2f},"
              f"{fmt(r.default)},{fmt(r.config)},{gain}")
    # every entry is held against the plain version before the file is
    # written: a failed check raises and leaves the file as it was
    checked = verify_dispatch(cache)
    for name, tag, cfg, err in checked:
        print(f"# dispatch {name} {tag} {cfg}: row-scaled error "
              f"{err:.3g} <= {VERIFY_TOL[name]:.3g}")
    path = cache.save()
    print(f"# wrote {path} ({len(results)} tuned, {len(checked)} entries "
          f"held against the plain versions)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
