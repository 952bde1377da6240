"""One-card dry-run: a production step of one arch at one input shape,
run on ``meta`` tensors, so nothing is allocated and no card is touched;
what it counts says whether the step fits one H100 and how long the card
would take at the least.

The step is the one the entry points run (``launch.steps``): the train
step (loss, LoRA gradients, AdamW) for ``train`` shapes, the prefill step
for ``prefill``, the serve step against a cache of ``cache_capacity`` for
``decode``, and with ``--k-local`` the federated round step.

The step follows the card's path: the model takes its kernel branches,
as on a Hopper card, and each hand kernel, which cannot run on ``meta``
(it launches through ctypes), resolves through ``dispatch.meta_kernels``
to a stand-in that makes its output and counts its FLOPs and bytes from
the shapes, as the kernel bounds of ``chip_smoke.py`` do; its backward is
the plain version's, as on the card, but for ``lora_matmul``'s input
gradient, which the card runs on a bf16 kernel (``kernels/ops.py``
``backward_route``) and meta tensors run as the plain f32 products, so
``flops_by_dtype`` counts it in f32. ``shape_counted_ops`` lists those
calls.

What it counts, in one run of the step:

* ``flops_per_device``: the FLOPs ``torch.utils.flop_counter.
  FlopCounterMode`` counts. It counts matmul-like aten ops only (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, convolutions, SDPA); elementwise work,
  reductions and the softmax are not in it. The matmuls are also split by
  dtype (``flops_by_dtype``): the card runs f32 products outside the
  tensor cores.
* ``bytes_per_device``: the bytes every non-view op reads and writes,
  each operand and each result counted once per op (a fused kernel would
  move fewer); an in-place scatter (a decode step's cache write) counts
  its indices and source and the rows it writes, not the destination.
* ``memory_analysis``: the argument bytes (params, LoRA, optimizer
  state, batch or cache, from ``launch.specs``), the output bytes (new
  storage only: a cache written in place is an argument), and
  the temp size: the peak of the bytes held by live storages, tallied as
  ops make them and as they are freed, less the arguments.
* ``t_compute`` / ``t_memory``: those counts over the H100 SXM's
  datasheet peaks (``kernels.common``): f32 matmul FLOPs at the f32
  rate, the rest at the bf16 tensor-core rate, bytes at the HBM rate.
  ``fits``: arguments plus temp within the card's 80 GB.

Every other op of the step runs on ``meta``: the MoE routing and its
fill are computed on the device, with no host read. Where a count
depends on the data (the MoE fill, a decode slot's valid length), the
stand-ins count the most it could need: every capacity row, every cache
row.

``calibrate`` keeps the JAX package's decomposition, fixed + Σ L ·
per-layer from depth-1 and depth-2 variants. The port runs layers in a
Python loop, so no count is folded as a scan is, and the corrected FLOPs
equal the full-depth count (the tests hold that). The bytes are not
linear in depth: in the backward each layer's view of a stacked LoRA
leaf makes a zero gradient the size of the whole stack, so the corrected
bytes fall short at depth, and ``bytes_per_device`` is the full-depth
count.

``--moe-path ep`` or ``gather_sharded`` builds the step on a 1x1 mesh
(``launch.mesh.make_host_mesh`` on the CPU: a world-1 ``gloo`` group,
which the meta tensors never reach, since a collective over one rank is
skipped) and counts it as the card runs it: ``ep``'s local capacity
(``moe_block_ep``'s ``cap_l``) sets its expert FLOPs, and
``gather_sharded`` counts what ``gather`` counts.

``--multi-pod`` adds ``per_device_argument_bytes``: for each input tree
(params, LoRA, optimizer state, batch, cache) the bytes of one device's
shards on the (2, 16, 16) mesh over ("pod", "data", "model"), by the
placement rules (``launch.sharding``); the other counts stay one card's.
The JAX package's dry-run also reads the compiled program's per-device
temp bytes and collective bytes off XLA's partitioned HLO; with no
partitioner in the port there is nothing to read them from, so they are
not counted.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch llama2-7b-proxy --shape train_4k [--remat <policy>] \\
        [--layers N] [--k-local K] [--moe-path ep] [--multi-pod] \\
        [--out-dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import weakref
from collections import Counter
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.interop import tree_leaves
from repro_torch.kernels import dispatch
from repro_torch.kernels.common import (H100_BF16_FLOPS, H100_F32_FLOPS,
                                        H100_HBM_BYTES,
                                        H100_HBM_BYTES_PER_S)
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import abstract_production_mesh, make_host_mesh
from repro_torch.launch.steps import (make_federated_round_step,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)

_aten = torch.ops.aten
_DOTS = {_aten.mm: (0, 1), _aten.addmm: (1, 2), _aten.bmm: (0, 1),
         _aten.baddbmm: (1, 2)}
#: ops that move no data: allocation without a fill, and aliasing
_NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.detach, _aten.alias, _aten.lift_fresh}
#: in-place scatters: they touch only the rows their source fills (a
#: decode step writes one row of each cache), not the whole destination
_SCATTERS = {_aten.index_put_, _aten._index_put_impl_, _aten.index_copy_,
             _aten.index_add_, _aten.scatter_, _aten.scatter_add_,
             _aten.masked_scatter_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tree, skip=()) -> int:
    """Bytes of the distinct storages under ``tree``, less those under
    ``skip``."""
    seen = {t.untyped_storage()._cdata for t in _tensors(skip)}
    stores = {t.untyped_storage()._cdata: t.untyped_storage()
              for t in _tensors(tree)}
    return sum(st.nbytes() for key, st in stores.items() if key not in seen)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class _Tally(TorchDispatchMode):
    """Bytes read and written per op, matmul FLOPs by dtype, and the live
    storages' bytes with their peak; the kernel stand-ins add theirs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.dot_flops: Counter = Counter()
        self.kernel_flops = 0
        self.kernel_calls: Counter = Counter()
        self.live = self.peak = 0
        self._sizes: Dict[int, int] = {}

    def add_kernel(self, name: str, flops: int, tensors, dtype) -> None:
        self.kernel_calls[name] += 1
        self.kernel_flops += flops
        self.dot_flops[_dtype_name(dtype)] += flops
        self.bytes += sum(_nbytes(t) for t in tensors)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        self._sizes[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        outs = _tensors(out)
        if packet in _DOTS:
            i, j = _DOTS[packet]
            a, b = args[i], args[j]
            self.dot_flops[_dtype_name(a.dtype)] += (
                2 * math.prod(a.shape) * b.shape[-1])
        if packet in _SCATTERS:
            # indices and source read, the source's size written
            src = _tensors((args[1:], kwargs))
            self.bytes += sum(_nbytes(t) for t in src) + max(
                (_nbytes(t) for t in src if t.is_floating_point()),
                default=0)
        elif not func.is_view and packet not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self.track(t)
        return out


def _live_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs an attention mask keeps, per head (Sq = Sk)."""
    if window is None or window >= s:
        return s * (s + 1) // 2 if causal else s * s
    if causal:
        return window * (window + 1) // 2 + (s - window) * window
    m = s - window
    return s * s - m * (m + 1) // 2


def _ssd_flops(bsz, s, h, p, n, chunk) -> int:
    """The SSD forward's FLOPs: per (batch, head) and chunk, the scores
    and the weighted sum over the live causal pairs, the inter-chunk term
    for every chunk but the first and the state update for every chunk
    but the last (``chip_smoke._ssd_flops``)."""
    chunk = min(chunk, s)
    lens = [min(chunk, s - s0) for s0 in range(0, s, chunk)]
    pairs = sum(c * (c + 1) // 2 for c in lens)
    inter = sum(lens[1:]) * 2 * n * p
    update = sum(lens[:-1]) * 2 * n * p
    return bsz * h * (pairs * 2 * (n + p) + inter + update)


def _stand_ins(tally: _Tally) -> Dict[str, object]:
    """Shape-only stand-ins of the five hand kernels on ``meta``: each
    makes its output and tells ``tally`` its FLOPs (the kernel bounds'
    counts) and the bytes of its operands and output."""
    def empty(shape, like):
        return torch.empty(shape, dtype=like.dtype, device=S.META)

    def lora_matmul(x, w, a, b, *, scaling=1.0, **_):
        (k, n), r = w.shape, a.shape[1]
        m = x.numel() // k
        out = empty((*x.shape[:-1], n), x)
        tally.add_kernel("lora_matmul",
                         2 * m * n * k + 2 * m * r * (k + n),
                         (x, w, a, b, out), x.dtype)
        return out

    def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                        **_):
        b, s, h, d = q.shape
        out = empty(q.shape, q)
        tally.add_kernel("flash_attention",
                         4 * d * b * h * _live_pairs(s, causal, window),
                         (q, k, v, out), q.dtype)
        return out

    def moe_expert_ffn(buf, wg, wu, wd, *, fill=None, **_):
        e, c, d = buf.shape
        out = empty(buf.shape, buf)
        tally.add_kernel("moe_expert_ffn", 6 * e * c * d * wg.shape[2],
                         (buf, wg, wu, wd, out), buf.dtype)
        return out

    def ssd_scan(x, dt, a, b, c, d, *, chunk=128, **_):
        bsz, s, h, p = x.shape
        out = empty(x.shape, x)
        tally.add_kernel("ssd_scan",
                         _ssd_flops(bsz, s, h, p, b.shape[-1], chunk),
                         (x, dt, a, b, c, d, out), x.dtype)
        return out

    def flash_decode(q, k, v, *, kv_valid_len, scale=None, **_):
        b, _one, h, hd = q.shape
        cap, vd = k.shape[1], v.shape[3]
        out = empty((b, 1, h, vd), v)
        tally.add_kernel("flash_decode", 2 * b * h * cap * (hd + vd),
                         (q, k, v, kv_valid_len, out), k.dtype)
        return out

    return {"lora_matmul": lora_matmul, "flash_attention": flash_attention,
            "moe_expert_ffn": moe_expert_ffn, "ssd_scan": ssd_scan,
            "flash_decode": flash_decode}


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = *active* params —
    routed-expert tensors count only their top_k/E fraction (MoE)."""
    p = S.param_specs(cfg)

    def leaf_count(tree):
        return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))

    n = float(leaf_count(p["embed"]) + leaf_count(p.get("lm_head", ())))
    for name in sorted(p["blocks"]):         # JAX's (sorted) dict order
        stack = p["blocks"][name]
        n += leaf_count(stack)
        ffn = stack.get("ffn", {})
        if "wg" in ffn and ffn["wg"].dim() == 4:
            m = cfg.moe
            expert_params = sum(math.prod(ffn[k].shape)
                                for k in ("wg", "wu", "wd"))
            n -= expert_params * (1 - m.top_k / m.n_experts)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def with_depths(cfg, depths: dict):
    """Config variant with per-stack depth overrides (calibration)."""
    if cfg.is_encdec:
        return dataclasses.replace(cfg, n_enc_layers=depths.get("enc", 1),
                                   n_layers=depths.get("dec", 1))
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        d, m = depths.get("dense", 1), depths.get("moe", 1)
        return dataclasses.replace(
            cfg, n_layers=d + m,
            moe=dataclasses.replace(cfg.moe, first_dense_layers=d))
    return dataclasses.replace(cfg, n_layers=depths.get("layers", 1))


def build_cfg(cfg, shape, *, k_local=0, rank=32, remat=True,
              aggregation="fedavg", hetero=False, moe_path="gather",
              mesh=None):
    """(step fn, meta args) of ``cfg`` at ``shape``, the MoE blocks on
    ``moe_path`` over ``mesh``."""
    if hetero and not k_local:
        raise ValueError("hetero=True runs the heterogeneous federated "
                         "round step and therefore requires k_local > 0")
    window = cfg.effective_window(shape)
    p_specs = S.param_specs(cfg)
    l_specs = S.lora_specs(cfg, rank)
    lr = torch.empty((), dtype=torch.float32, device=S.META)
    if k_local:  # federated round step (DEVFT dry-run extra)
        from types import SimpleNamespace

        from repro_torch.federated import aggregation as agg_mod
        n_clients = 2
        bsp = S.batch_specs(cfg, shape, with_labels=True)
        cb = {k: v.new_empty((n_clients, k_local) + tuple(v.shape))
              for k, v in bsp.items()}
        agg_kw = agg_mod.extra_kwargs(
            aggregation, SimpleNamespace(flora_ranks=None, lora_rank=rank),
            n_clients)
        fn = make_federated_round_step(cfg, k_local=k_local, window=window,
                                       moe_path=moe_path, mesh=mesh,
                                       remat=remat, aggregation=aggregation,
                                       agg_kwargs=agg_kw, hetero=hetero)
        args = (p_specs, l_specs, cb, lr)
        if hetero:
            args += (torch.empty((n_clients, k_local), device=S.META),
                     torch.empty((n_clients,), device=S.META))
        return fn, args
    if shape.kind == "train":
        fn = make_train_step(cfg, window=window, moe_path=moe_path,
                             mesh=mesh, remat=remat)
        args = (p_specs, l_specs, S.opt_specs(l_specs),
                S.batch_specs(cfg, shape, with_labels=True), lr)
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg, window=window, moe_path=moe_path,
                               mesh=mesh)
        args = (p_specs, l_specs, S.batch_specs(cfg, shape,
                                                with_labels=False))
    else:
        fn = make_serve_step(cfg, moe_path=moe_path, mesh=mesh)
        args = (p_specs, l_specs, S.token_specs(shape),
                S.cache_specs(cfg, shape))
    return fn, args


def build(arch: str, shape_name: str, *, moe_path: str = "gather",
          k_local: int = 0, rank: int = 32, remat=True, layers: int = 0,
          aggregation: str = "fedavg", hetero: bool = False):
    """(cfg, shape, step fn, meta args, mesh) of ``arch`` at the input
    shape ``shape_name``; the mesh is the 1x1 one ``ep`` and
    ``gather_sharded`` run on (None for ``gather``)."""
    mesh = None if moe_path == "gather" else make_host_mesh("cpu")
    cfg = get_config(arch)
    if layers:
        # DEVFT stage-submodel roofline: a fused submodel IS a shallower
        # model of the same family (core.devft), so the depth override
        # reproduces its cost structure exactly
        sizes = dict(cfg.layer_stacks())
        if len(sizes) == 1:
            cfg = with_depths(cfg, {next(iter(sizes)): layers})
        else:
            from repro_torch.core.stages import allocate_stack_capacities
            cfg = with_depths(cfg, allocate_stack_capacities(sizes, layers))
    shape = INPUT_SHAPES[shape_name]
    fn, args = build_cfg(cfg, shape, k_local=k_local, rank=rank,
                         remat=remat, aggregation=aggregation, hetero=hetero,
                         moe_path=moe_path, mesh=mesh)
    return cfg, shape, fn, args, mesh


def measure(fn, args) -> dict:
    """Run ``fn(*args)`` on meta tensors under the counters, on the
    card's path (the kernels' shape-only stand-ins)."""
    arg_bytes = _storage_bytes(args)
    tally = _Tally()
    for t in _tensors(args):
        tally.track(t)
    flop_counter = FlopCounterMode(display=False)
    with dispatch.meta_kernels(_stand_ins(tally)), flop_counter, tally:
        out = fn(*args)
    # what the step returns in new storage (a cache written in place is
    # an argument's)
    out_bytes = _storage_bytes(out, skip=args)
    return {"flops": float(flop_counter.get_total_flops()
                           + tally.kernel_flops),
            "bytes": float(tally.bytes),
            "dot_flops": dict(tally.dot_flops),
            "kernel_calls": dict(tally.kernel_calls),
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": tally.peak - arg_bytes}


def calibrate(cfg, shape, *, k_local=0, rank=32, remat=True,
              moe_path="gather", mesh=None):
    """Per-layer cost from depth-1 and depth-2 variants of each stack:
    corrected totals = fixed + Σ_stack L·per_layer, as the JAX package
    recovers them from unrolled lowers. None for the hybrid family (the
    JAX package's rule: its depth does not split by stack)."""
    if cfg.family == "hybrid":
        return None
    stacks = [name for name, _n in cfg.layer_stacks()]
    full = dict(cfg.layer_stacks())

    def cost(depths):
        fn, args = build_cfg(with_depths(cfg, depths), shape,
                             k_local=k_local, rank=rank, remat=remat,
                             moe_path=moe_path, mesh=mesh)
        m = measure(fn, args)
        return (m["flops"], m["bytes"])

    # the counts are exact, so unlike the JAX package's no term is
    # clipped at zero: ``fixed`` may be negative, since a stack's first
    # layer costs less than the others where it computes no gradient of
    # its input (the embeddings are frozen)
    base_depths = {s: 1 for s in stacks}
    base = cost(base_depths)
    per_layer = {}
    for s in stacks:
        m = cost({**base_depths, s: 2})
        per_layer[s] = tuple(a - b for a, b in zip(m, base))
    fixed = tuple(b - sum(p[i] for p in per_layer.values())
                  for i, b in enumerate(base))
    corrected = tuple(fixed[i] + sum(full[s] * per_layer[s][i]
                                     for s in stacks) for i in range(2))
    return {"fixed": list(fixed),
            "per_layer": {s: list(v) for s, v in per_layer.items()},
            "corrected_flops_per_device": corrected[0],
            "corrected_bytes_per_device": corrected[1]}


def roofline_terms(flops: float, bytes_moved: float,
                   dot_flops: Dict[str, float]) -> dict:
    """The least time on one H100 SXM at its datasheet peaks: f32 matmul
    FLOPs at the f32 rate, the rest at the bf16 tensor-core rate."""
    f32 = dot_flops.get("float32", 0.0)
    terms = {"compute": f32 / H100_F32_FLOPS
             + max(flops - f32, 0.0) / H100_BF16_FLOPS,
             "memory": bytes_moved / H100_HBM_BYTES_PER_S}
    return {"t_compute": terms["compute"], "t_memory": terms["memory"],
            "bottleneck": max(terms, key=terms.get)}


def _argument_trees(mesh, kind: str, args, k_local: int):
    """[(name, tree, shardings)] of a step's input trees, placed as the
    JAX package's dry-run places them."""
    p, lo, *rest = args
    out = [("params", p, shd.params_shardings(mesh, p)),
           ("lora", lo, shd.params_shardings(mesh, lo))]
    if k_local or kind == "prefill":
        out.append(("batch", rest[0], shd.batch_shardings(mesh, rest[0])))
    elif kind == "train":
        out += [("opt_state", rest[0], shd.params_shardings(mesh, rest[0])),
                ("batch", rest[1], shd.batch_shardings(mesh, rest[1]))]
    else:
        out += [("batch", rest[0], shd.batch_shardings(mesh, rest[0])),
                ("cache", rest[1], shd.cache_shardings(mesh, rest[1]))]
    return out


def per_device_argument_bytes(mesh, kind: str, args, k_local: int = 0
                              ) -> Dict[str, int]:
    """The bytes of one device's shards of each input tree on ``mesh``
    (``sharding.shard_shape`` of every leaf)."""
    return {name: sum(math.prod(shd.shard_shape(mesh, sh.spec, t.shape))
                      * t.element_size()
                      for t, sh in zip(tree_leaves(tree),
                                       tree_leaves(shardings)))
            for name, tree, shardings in _argument_trees(mesh, kind, args,
                                                         k_local)}


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            out_dir: Optional[str] = None, *, moe_path: str = "gather",
            k_local: int = 0, tag: str = "", remat=True, layers: int = 0,
            aggregation: str = "fedavg", hetero: bool = False,
            rank: int = 32) -> dict:
    t0 = time.time()
    cfg, shape, fn, args, mesh = build(
        arch, shape_name, moe_path=moe_path, k_local=k_local, rank=rank,
        remat=remat, layers=layers, aggregation=aggregation, hetero=hetero)
    m = measure(fn, args)
    run_s = time.time() - t0
    cal = calibrate(cfg, shape, k_local=k_local, rank=rank, remat=remat,
                    moe_path=moe_path, mesh=mesh)
    mf = model_flops(cfg, shape)
    mem = {k: m[k] for k in ("argument_size_in_bytes",
                             "output_size_in_bytes", "temp_size_in_bytes")}
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    res = {
        "arch": arch, "shape": shape.name, "chips": 1,
        "device": "NVIDIA H100 SXM 80GB (datasheet peaks)",
        "mesh": None if mesh is None else "1x1",
        "moe_path": moe_path, "k_local": k_local, "hetero": hetero,
        "remat": remat, "layers": layers or None, "tag": tag,
        "run_s": round(run_s, 1),
        "flops_per_device": m["flops"],
        "bytes_per_device": m["bytes"],
        "flops_by_dtype": m["dot_flops"],
        "calibration": cal,
        "model_flops": mf,
        "useful_ratio": (mf / m["flops"]) if m["flops"] else None,
        "memory_analysis": mem,
        "peak_bytes": peak,
        "fits": peak <= H100_HBM_BYTES,
        "shape_counted_ops": m["kernel_calls"],
    }
    res.update(roofline_terms(m["flops"], m["bytes"], m["dot_flops"]))
    if multi_pod:
        res["per_device_argument_bytes"] = per_device_argument_bytes(
            abstract_production_mesh(multi_pod=True), shape.kind, args,
            k_local)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = (f"_{tag}" if tag else "") + ("_fed" if k_local else "") \
            + ("_het" if hetero else "") + ("_mp" if multi_pod else "") \
            + (f"_{moe_path}" if moe_path != "gather" else "")
        path = os.path.join(out_dir, f"{arch}_{shape.name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description="one-card dry-run on meta "
                                             "tensors")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="also report each input tree's bytes per device "
                         "on the 2x16x16 mesh")
    ap.add_argument("--moe-path", default="gather",
                    choices=["gather", "gather_sharded", "ep"],
                    help="the MoE blocks' path; ep and gather_sharded run "
                         "on a 1x1 mesh")
    ap.add_argument("--k-local", type=int, default=0,
                    help="run the federated round step with K local steps")
    ap.add_argument("--aggregation", default="fedavg",
                    help="registered server aggregation of the federated "
                         "round step (with --k-local)")
    ap.add_argument("--hetero", action="store_true",
                    help="the heterogeneous-client round step (ragged step "
                         "masks + aggregation weights; with --k-local)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat", default="true",
                    help="true | false | <jax.checkpoint_policies name>")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth override (DEVFT stage submodels)")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    res = run_one(args.arch, args.shape, args.multi_pod, args.out_dir,
                  moe_path=args.moe_path, k_local=args.k_local,
                  tag=args.tag,
                  remat={"true": True, "false": False}.get(
                      args.remat.lower(), args.remat),
                  layers=args.layers, aggregation=args.aggregation,
                  hetero=args.hetero)
    print(json.dumps({k: v for k, v in res.items()
                      if k != "memory_analysis"}, indent=1))
    print("memory_analysis:", json.dumps(res["memory_analysis"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
