"""The benchmark's operation and byte counts against hand counts at small
shapes: each kernel file and the step count behind ``mfu``."""
from __future__ import annotations

import json

import pytest
import torch

from fedbench.bench import Bench
from fedbench.flops import round_flops
from fedbench.reference import model as M

KERNELS = Bench().kernel_files()


def test_lora_matmul_counts():
    x = torch.zeros(2, 3, 8, dtype=torch.bfloat16)      # M = 6, K = 8
    w, a, b = (torch.zeros(8, 5, dtype=torch.bfloat16),
               torch.zeros(8, 2, dtype=torch.bfloat16),
               torch.zeros(2, 5, dtype=torch.bfloat16))
    ops, nbytes, dtype = KERNELS["lora_matmul"].count(
        KERNELS["lora_matmul"].record((x, w, a, b), {"scaling": 2.0}))
    assert ops == 2 * 6 * 8 * 5 + 2 * 6 * 8 * 2 + 2 * 6 * 2 * 5
    assert nbytes == 2 * (6 * 8 + 8 * 5 + 8 * 2 + 2 * 5 + 6 * 5)
    assert dtype == "bfloat16"


@pytest.mark.parametrize("causal,pairs", [(True, 4 * 5 // 2), (False, 16)])
def test_flash_attention_counts(causal, pairs):
    q = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)   # B1 S4 H2 D8
    k = torch.zeros(1, 4, 1, 8, dtype=torch.bfloat16)
    mod = KERNELS["flash_attention"]
    ops, nbytes, _ = mod.count(mod.record((q, k, k), {"causal": causal}))
    # QK^T and PV: 2 products of 2 flops over each live (query, key) pair
    assert ops == 2 * 2 * 2 * 8 * pairs
    assert nbytes == 2 * 4 * 8 * (2 + 2 + 1 + 1)


def test_moe_expert_ffn_counts_live_rows_only():
    e, c, d, ff = 3, 4, 8, 6
    buf = torch.zeros(e, c, d, dtype=torch.bfloat16)
    wg = torch.zeros(e, d, ff, dtype=torch.bfloat16)
    wd = torch.zeros(e, ff, d, dtype=torch.bfloat16)
    fill = torch.tensor([4, 1, 0], dtype=torch.int32)
    mod = KERNELS["moe_expert_ffn"]
    ops, nbytes, _ = mod.count(mod.record((buf, wg, wg, wd), {"fill": fill}))
    assert ops == 5 * (2 * d * ff * 2 + 2 * ff * d)
    # 5 live rows in and out, the weights of the 2 experts with a live row
    assert nbytes == 2 * (2 * 5 * d + 2 * 3 * d * ff)


def test_ssd_scan_counts():
    b, s, h, p, g, n = 1, 8, 2, 4, 1, 3
    x = torch.zeros(b, s, h, p, dtype=torch.bfloat16)
    dt = torch.zeros(b, s, h)
    bc = torch.zeros(b, s, g, n, dtype=torch.bfloat16)
    mod = KERNELS["ssd_scan"]
    ops, nbytes, _ = mod.count(mod.record((x, dt, dt[0, 0], bc, bc, dt[0, 0]),
                                          {"chunk": 4}))
    assert ops == b * s * h * (4 * (n + p) + 4 * p * n)
    assert nbytes == 2 * 2 * b * s * h * p + 4 * b * s * h + 2 * 2 * b * s * g * n


def _model(**kw):
    m = {"family": "moe", "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 6, "vocab": 100, "tie_embeddings": True,
         "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 6}}
    m.update(kw)
    return m


def test_step_count_moe_layer_by_hand():
    m, s, r = _model(), 10, 2
    fwd, bwd = M.per_token(m, {"layers": 1}, s, r)
    d, hd = 8, 4
    frozen = 2 * d * (2 * hd + 2 * hd) + 2 * 2 * hd * d   # q, k, v, o
    frozen += 2 * d * 4 + 2 * 6 * d * 6                   # router, top-2
    lora = 2 * r * (d + 2 * hd) + 2 * r * (d + hd)        # W_q, W_v
    scores = 2 * 2 * hd * s
    head = 2 * d * 128                                    # padded vocab
    assert fwd == frozen + lora + scores + head
    assert bwd == frozen + 2 * lora + 2 * scores + head


def test_round_count_scales_with_clients_steps_and_eval():
    m = _model()
    spec = {"seq": 10, "k_local": 3, "local_batch": 2}
    fwd, bwd = M.per_token(m, {"layers": 2}, 10, 2)
    got = round_flops(M, m, {"layers": 2}, spec, 2, 4, 2)
    assert got == 2 * 3 * 2 * 10 * (fwd + bwd) + 4 * 10 * fwd


def test_step_count_at_published_widths():
    """granite's full depth: ~1.8 GFLOP a token (forward + backward)."""
    doc = json.loads((Bench().here / "configs" /
                      "granite-moe-1b-a400m.json").read_text())
    fwd, bwd = M.per_token(doc["model"], {"layers": 24}, 512, 32)
    assert 1.7e9 < fwd + bwd < 1.9e9
