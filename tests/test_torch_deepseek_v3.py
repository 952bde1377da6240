"""DeepSeek-V3's published rules in the port against the benchmark's
plain reference (``fedbench/reference/deepseek_v3.py``), on the CPU, on
seeded random weights at a small size in f32.

* The grouped sigmoid router: indices exactly, weights to 1e-6 (the
  same f32 products in another order); ties to the lower index, groups
  and experts alike; the correction bias changes selections and never a
  weight.
* The sequence-wise balance loss: the reference's and a loop over the
  sequences written from eq. 17-20, to 1e-6 relative.
* YaRN: the tables to 1e-5 (two f32 blends of the same frequencies; an
  angle at position 511 carries 511 times the frequency's last bit), the
  ramp between dims 10 and 23 of DeepSeek-V3's 32, the softmax scale
  1/sqrt(192) x 1.8738; plain RoPE's tables unchanged bit for bit.
* ``moe_block`` with an expert share: 16 experts in 4 shares of 4, the
  shares' outputs with the shared expert counted once equal the uncut
  layer and the reference's, to 1e-5; no slot drops; the held-slot
  counter.
* MLA on the kernel branch (v zero-padded to q/k's head dim, the flash
  attention's plain version, the output sliced) equals the unpadded
  plain path, output and gradients, to 1e-5 of their norms.
* The reduced model's loss and LoRA gradients, whole and as a DevFT
  submodel, against the reference, to 1e-4 relative (f32, different
  orders of sums over 8 layers); a toy cell through ``fedbench/run.py``
  comes out ``correct`` at tight limits.
* The spans ``mla.latent``, ``mla.expand``, ``mla.attend`` and the
  counters under a profiler.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fedbench.reference import deepseek_v3 as R  # noqa: E402
from fedbench.reference import model as RM  # noqa: E402
from fedbench.runners.federated import model_config  # noqa: E402
from fedbench import weights as W  # noqa: E402
from repro_torch.analysis import tracing  # noqa: E402
from repro_torch.configs import RopeScaling, get_config  # noqa: E402
from repro_torch.core.devft import build_submodel  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import moe as Moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)

CONFIG = ROOT / "fedbench" / "configs" / "deepseek-v3-8l.json"
YARN = RopeScaling(factor=40, original_max_position_embeddings=4096,
                   beta_fast=32, beta_slow=1, mscale=1, mscale_all_dim=1)
#: the configuration file cut to a toy: widths, 16 routed experts in 4
#: groups (2 kept), 4 a token, 4 held
TOY = {"d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 96,
       "vocab": 256, "dtype": "float32"}
TOY_MLA = {"q_lora_rank": 32, "kv_lora_rank": 16, "qk_rope_head_dim": 8,
           "qk_nope_head_dim": 16, "v_head_dim": 16}
TOY_MOE = {"n_experts": 4, "n_routed": 16, "n_group": 4, "topk_group": 2,
           "top_k": 4, "d_ff_expert": 32}


def toy_doc(**moe):
    doc = json.loads(CONFIG.read_text())
    doc["model"].update(TOY)
    doc["model"]["mla"] = dict(TOY_MLA)
    doc["model"]["moe"].update(TOY_MOE, **moe)
    doc["lora"]["rank"] = 4
    for rule in doc["init"]:
        if "e_score_correction_bias" in rule[0]:
            rule[1] = {"normal": 0.1}     # a toy router's score spread
    return doc


def toy_model(seed=5, **moe):
    """(configuration's model section, port config, params, lora with B
    random so every factor has a gradient)."""
    doc = toy_doc(**moe)
    cfg = dataclasses.replace(model_config(doc["model"]),
                              kernel_backend="reference")
    params, lora = W.make(cfg, doc, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    lora = {s: {k: {"a": v["a"], "b": torch.randn(
        v["b"].shape, generator=gen) * 0.1} for k, v in st.items()}
        for s, st in lora.items()}
    return doc["model"], cfg, params, lora


def batch(b=2, s=16, seed=0):
    tokens = torch.randint(0, 256, (b, s),
                           generator=torch.Generator().manual_seed(seed))
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def leaves(t):
    return [x for k in sorted(t) for x in
            (leaves(t[k]) if isinstance(t[k], dict) else [t[k]])]


def rel(a, b):
    return float((a - b).norm() / b.norm())


def _router(seed=1, t=64, d=32, n=32, bias=0.1):
    gen = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn((d, n), generator=gen) / math.sqrt(d),
         "e_score_correction_bias": torch.randn((n,), generator=gen) * bias}
    x = torch.randn((t, d), generator=gen)
    mo = {"n_routed": n, "top_k": 4, "n_group": 4, "topk_group": 2,
          "routed_scale": 2.5, "router_aux_coef": 1e-4}
    cfg = model_config({**TOY, "arch_id": "toy", "family": "moe",
                        "n_layers": 2, "moe": {
                            "n_experts": n, "top_k": 4, "d_ff_expert": 8,
                            "scoring": "sigmoid", "n_group": 4,
                            "topk_group": 2, "routed_scale": 2.5,
                            "router_aux_coef": 1e-4}})
    return cfg, mo, p, x


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def test_grouped_sigmoid_router_matches_the_reference():
    cfg, mo, p, x = _router()
    w, idx, _ = Moe.router_topk(p, cfg, x, (4, 16))
    rw, ridx, _ = R.route(p, mo, x)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(w, rw, rtol=1e-6, atol=1e-6)
    # every token's experts lie in 2 of the 4 groups of 8
    for row in idx // 8:
        assert len(set(row.tolist())) <= 2
    torch.testing.assert_close(w.sum(-1), torch.full((64,), 2.5))


def test_router_ties_go_to_the_lower_index():
    cfg, mo, p, x = _router()
    p = {k: torch.zeros_like(v) for k, v in p.items()}
    w, idx, _ = Moe.router_topk(p, cfg, x, (4, 16))
    _, ridx, _ = R.route(p, mo, x)
    # every score ties: groups 0 and 1 kept, experts 0..3 taken
    assert torch.equal(idx, torch.arange(4).expand(64, 4))
    assert torch.equal(ridx, idx)
    torch.testing.assert_close(w, torch.full((64, 4), 2.5 / 4))


def test_the_bias_changes_selections_never_weights():
    cfg, mo, p, x = _router(bias=0.3)
    w, idx, _ = Moe.router_topk(p, cfg, x, (4, 16))
    w0, idx0, _ = Moe.router_topk(
        {**p, "e_score_correction_bias": torch.zeros(32)}, cfg, x, (4, 16))
    assert not torch.equal(idx, idx0)
    scores = torch.sigmoid(x @ p["router"]).gather(1, idx)
    torch.testing.assert_close(w, 2.5 * scores / scores.sum(-1, keepdim=True))


def test_sequence_wise_balance_loss():
    cfg, mo, p, x = _router()
    _, idx, aux = Moe.router_topk(p, cfg, x, (4, 16))
    _, ref_aux = R.moe({**p, "shared": {
        "wg": torch.zeros(32, 1), "wu": torch.zeros(32, 1),
        "wd": torch.zeros(1, 32)}}, {"moe": {**mo, "n_experts": 0}}, x, 4)
    # eq. 17-20, one sequence at a time
    s = torch.sigmoid(x @ p["router"])
    want = 0.0
    for seq in range(4):
        rows = slice(16 * seq, 16 * seq + 16)
        sn = s[rows] / s[rows].sum(-1, keepdim=True)
        for e in range(32):
            f = 32 / (4 * 16) * float((idx[rows] == e).sum())
            want += f * float(sn[:, e].mean())
    want = want / 4 * 1e-4
    assert abs(float(aux) - want) <= 1e-6 * want
    assert abs(float(ref_aux) - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def test_yarn_tables_and_scale_match_the_reference():
    pos = Lyr.text_positions(1, 512)
    cos, sin = Lyr.rope_cos_sin(pos, 64, 1e4, YARN)
    rc, rs, factor = R.yarn(512, 64, 1e4, dataclasses.asdict(YARN), "cpu")
    torch.testing.assert_close(cos[0], rc, rtol=0, atol=1e-5)
    torch.testing.assert_close(sin[0], rs, rtol=0, atol=1e-5)
    inv = 1.0 / 1e4 ** (torch.arange(32, dtype=torch.float32) / 32)
    got = Lyr.yarn_inv_freq(inv, 64, 1e4, YARN)
    assert torch.equal(got[:11], inv[:11])               # fast dims kept
    torch.testing.assert_close(got[23:], inv[23:] / 40)  # slow dims / 40
    assert bool(((got[11:23] < inv[11:23]) & (got[11:23] > inv[11:23] / 40))
                .all())
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              rope_scaling=YARN)
    want = (0.1 * math.log(40) + 1) ** 2 / math.sqrt(192)
    assert abs(Lyr.softmax_scale(cfg, 192) - want) <= 1e-12
    assert abs(want * math.sqrt(192) - 1.8738) < 1e-4
    assert abs(factor - want * math.sqrt(192)) <= 1e-12


def test_plain_rope_tables_are_unchanged():
    pos = Lyr.text_positions(2, 64, offset=3)
    half = 32
    exps = torch.arange(half, dtype=torch.float32) / half
    ang = pos.float()[..., None] * (1.0 / (1e4 ** exps))
    cos, sin = Lyr.rope_cos_sin(pos, 64, 1e4)
    assert torch.equal(cos, torch.cos(ang)) and torch.equal(sin, torch.sin(ang))


# ---------------------------------------------------------------------------
# the expert share
# ---------------------------------------------------------------------------

def test_expert_shares_sum_to_the_whole_layer():
    model, cfg, params, _ = toy_model(n_experts=16, top_k=4)
    p = T._layer(params["blocks"]["moe"], 0)["ffn"]
    x = torch.randn((32, 64), generator=torch.Generator().manual_seed(2))
    whole, aux = Moe.moe_block(p, cfg, x, batch_shape=(2, 16))
    shared = Lyr.mlp(p["shared"], x[None])[0]
    parts = torch.zeros_like(x)
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for first in range(0, 16, 4):
            share = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_experts=4, first_expert=first))
            ps = {**p, **{k: p[k][first:first + 4] for k in ("wg", "wu",
                                                             "wd")}}
            y, a = Moe.moe_block(ps, share, x, batch_shape=(2, 16))
            parts += y - shared
            assert float(a) == float(aux)
        c = tracing.counters()
    torch.testing.assert_close(parts + shared, whole, rtol=1e-5, atol=1e-5)
    ref, ref_aux = R.moe(p, {**model, "moe": {**model["moe"],
                                              "n_experts": 16}}, x, 2)
    torch.testing.assert_close(whole, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux, ref_aux, rtol=1e-5, atol=0)
    # every routed slot lands on one share's held experts; none drops
    assert c["moe.routed_slots"] == 4 * 32 * 4
    assert c["moe.held_slots"] == 32 * 4 and c["moe.dropped_slots"] == 0


def test_share_capacity_holds_every_token():
    _, cfg, _, _ = toy_model()
    assert cfg.moe.scoring == "sigmoid"
    for t in (1, 8, 9, 8192):
        cap = Moe._capacity(cfg, t)
        assert cap >= t and cap % 8 == 0
    # held experts 0 and 1, which every token routes to, fill every row;
    # the slots on experts 5 and 6, absent here, take none
    idx = torch.tensor([0, 1, 5, 6]).repeat(64)
    held = idx < 4
    pos, keep, fill = Moe._dispatch_indices(idx, 4, Moe._capacity(cfg, 64),
                                            held)
    assert torch.equal(keep, held) and fill.tolist() == [64, 64, 0, 0]
    assert pos[keep].tolist() == [i for t in range(64) for i in (t, t)]


# ---------------------------------------------------------------------------
# MLA on the kernel branch
# ---------------------------------------------------------------------------

def test_mla_pad_and_slice_equals_the_plain_path(monkeypatch):
    _, cfg, params, lora = toy_model()
    p = T._layer(params["blocks"]["dense"], 0)["mixer"]
    lo = T._layer(lora["dense"], 0)
    x = torch.randn((2, 16, 64), generator=torch.Generator().manual_seed(4))
    cos, sin = Lyr.rope_cos_sin(Lyr.text_positions(2, 16), 8, 1e4, YARN)

    def run():
        xx = x.clone().requires_grad_(True)
        ll = {n: {k: v.clone().requires_grad_(True) for k, v in t.items()}
              for n, t in lo.items()}
        y = Lyr.mla_attention(p, cfg, xx, cos, sin, lora=ll)
        gs = torch.autograd.grad(y.square().sum(), [xx] + leaves(ll))
        return [y] + list(gs)
    plain = run()
    seen = []
    flash = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return flash(q, k, v, **kw)
    monkeypatch.setattr(dispatch, "use_kernel", lambda *a, **k: True)
    monkeypatch.setattr(ops, "flash_attention", spy)
    kernel = run()
    assert seen == [(24, 24, 24)]
    # relative norms: the kernel branch's LoRA backward sums in its own
    # order (f32)
    for a, b in zip(kernel, plain):
        assert a.shape == b.shape and rel(a, b) <= 1e-5


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_reduced_model_loss_and_grads_match_the_reference():
    model, cfg, params, lora = toy_model()
    b = batch()
    _, met, grads = T.loss_and_lora_grads(cfg, params, lora, b)
    ref = R.Model(model, params)
    sub = {"dense": [[0], [1], [2]], "moe": [[i] for i in range(5)]}
    rl, rg = RM.grads(ref, sub, lora, b)
    assert abs(float(met["loss"]) - rl) <= 1e-5 * rl
    for g, r in zip(leaves(grads), leaves(rg)):
        assert rel(g, r) <= 1e-4


def test_devft_submodel_matches_the_reference():
    model, cfg, params, lora = toy_model(seed=6)
    sm = build_submodel(cfg, params, lora, 4, beta=0.1, seed=(6, 2))
    assert {n: len(p["groups"]) for n, p in sm.plan.items()} == \
        {"dense": 2, "moe": 2}
    b = batch(seed=1)
    _, met, grads = T.loss_and_lora_grads(sm.cfg, sm.params, sm.lora, b)
    ref = R.Model(model, params, beta=0.1)
    sub = {n: p["groups"] for n, p in sm.plan.items()}
    rl, rg = RM.grads(ref, sub, sm.lora, b)
    assert abs(float(met["loss"]) - rl) <= 1e-5 * rl
    for g, r in zip(leaves(grads), leaves(rg)):
        assert rel(g, r) <= 1e-4


def test_spans_and_counters_under_a_profiler():
    _, cfg, params, lora = toy_model()
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.loss_and_lora_grads(cfg, params, lora, batch())
    c = tracing.counters()
    names = {e.name for e in prof.events()}
    for span in ("mla.latent", "mla.expand", "mla.attend"):
        assert tracing.PREFIX + span in names
    n = sum(1 for e in prof.events()
            if e.name == tracing.PREFIX + "mla.attend")
    assert n == 8                                  # one an MLA layer
    assert c["moe.routed_slots"] == 5 * 32 * 4     # 5 MoE layers, T k
    assert 0 < c["moe.held_slots"] < c["moe.routed_slots"]
    assert c["moe.dropped_slots"] == 0
    tracing.reset_counters()
    T.loss_and_lora_grads(cfg, params, lora, batch())
    assert tracing.counters()["moe.held_slots"] == 0   # off unprofiled


def test_toy_cell_is_correct_through_the_harness(tmp_path):
    """The new configuration's cell at toy widths through
    ``fedbench/run.py`` on the CPU in a process of its own (this one holds
    JAX): every number within 1e-4 of the reference, f32 on both sides."""
    here = tmp_path / "fb"
    import shutil
    shutil.copytree(ROOT / "fedbench", here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (here / "configs" / "deepseek-v3-8l.json").write_text(
        json.dumps(toy_doc()))
    tr = here / "traffic" / "devft-k10-b16s512.json"
    doc = json.loads(tr.read_text())
    doc["spec"].update(k_local=3, local_batch=2, seq=16)
    tr.write_text(json.dumps(doc))
    lim = {k: {"limit": 1e-4} for k in ("loss", "grad", "grad_err",
                                        "update", "eval", "agg")}
    lim.update({k: {"limit": 0} for k in ("entry", "cohort", "groups",
                                          "transfer")})
    (here / "limits" / "deepseek-v3-8l.devft.json").write_text(
        json.dumps(lim))
    cmd = [sys.executable, str(ROOT / "fedbench" / "tests" / "run_cpu.py"),
           "--here", str(here), "--bench-json", str(ROOT / "BENCHMARK.json"),
           "--", "--workload", "deepseek-v3-8l.devft", "--seed",
           "3000000001", "--seconds", "0.5", "--trace", "1"]
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}",
               OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["metrics"]["moe_dropped_pct"]["value"] == 0.0


def test_mla_attention_pct_counts_each_device_second_once():
    """The metric over a summary shaped as the card's: the forward spans,
    the latent and expansion backward, the flash backward's own span; not
    ``mla.attend``'s backward, which repeats part of that span."""
    from fedbench.bench import Bench

    read = Bench().reader("mla_attention_pct")
    prog = {"program_s": {"mla.latent": 1.0, "mla.expand": 2.0,
                          "mla.attend": 3.0, "step.backward": 20.0,
                          "kernel.flash_attention.backward": 10.0,
                          "kernel.lora_matmul.backward": 1.5},
            "program_bwd_s": {"mla.latent": 0.5, "mla.expand": 2.5,
                              "mla.attend": 4.0}}
    ctx = type("Ctx", (), {"program": prog, "trace": {"busy_s": 40.0}})
    assert read(ctx) == pytest.approx(100.0 * 19.0 / 40.0)
    ctx.program = {"program_s": {"step.backward": 20.0}}
    assert read(ctx) is None
