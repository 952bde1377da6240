"""A configuration brings its own reference module (``fedbench.reference``):
the loader finds it by the name in the configuration file and nowhere else;
a test-only module with a stack kind ``model.py`` lacks, added as files in a
temporary copy, is what the window's FLOP count and the check's loss reach;
and the move of the FLOP count into ``reference/model.py`` left the counts
and the loss where they were (numbers taken on the code before the move)."""
from __future__ import annotations

import hashlib
import json

import pytest
import torch

from fedbench import check, data as D
from fedbench.bench import Bench
from fedbench.flops import round_flops
from fedbench.reference import devft as RD, model as M, module_for
from fedbench.reference.fed import follow, stage_plan

#: a reference module of its own: granite's layers under the stack kind
#: "tagged_moe", which model.py does not know; it notes what reached it
TAGGED = '''
from fedbench.reference import model as M

SEEN = []


def stack_kinds(model):
    return {"layers": "tagged_moe"}


def execution_order(model, sizes):
    return [("layers", i) for i in range(sizes.get("layers", 0))]


padded_vocab = M.padded_vocab


def per_token(model, sizes, s, r):
    SEEN.append("per_token")
    frozen, lora, scores = M._attention_flops(model, s, r)
    frozen += M._ffn_flops(model, "moe")
    n = sizes.get("layers", 0)
    head = 2 * model["d_model"] * padded_vocab(model)
    return (n * (frozen + lora + scores) + head,
            n * (frozen + 2 * lora + 2 * scores) + head)


class Model(M.Model):
    def stack_kinds(self):
        return stack_kinds(self.model)

    def execution_order(self, sizes):
        return execution_order(self.model, sizes)

    def block(self, p, kind, x, pos, lora):
        assert kind == "tagged_moe", kind
        SEEN.append(kind)
        cos, sin = pos
        return M.block(p, self.model, "gqa_moe", x, cos, sin, lora)
'''


def _add_tagged(bench):
    """The module and a configuration naming it, as new files only."""
    (bench.here / "reference" / "tagged.py").write_text(TAGGED)
    doc = bench.config("granite-moe-1b-a400m")
    doc.update(name="granite-tagged", reference="tagged")
    (bench.here / "configs" / "granite-tagged.json").write_text(
        json.dumps(doc))
    return bench.config("granite-tagged")


def test_a_configuration_reaches_its_own_module(toy_bench):
    """A whole FedIT job through the window, its FLOP count and the check's
    reference all run the configuration's own module."""
    before = {p: p.read_bytes() for p in toy_bench.here.rglob("*")
              if p.is_file()}
    doc = _add_tagged(toy_bench)
    assert {p: p.read_bytes() for p in before} == before
    mod = toy_bench.reference(doc)
    assert mod.__file__ == str(toy_bench.here / "reference" / "tagged.py")
    traffic = toy_bench.traffic("fedit-k10-b16s512")
    fed = toy_bench.runner(traffic)
    cell = fed.Cell(doc, mod, traffic, 6, "cpu", {})
    cap = fed.Capture(cell)
    win = fed.Window(cell, 0.0)
    win.run(cap)
    flops = win.flops()
    assert mod.SEEN == ["per_token"] * len(win.rounds)
    # the same layers as granite's, so model.py counts them alike
    assert flops == sum(round_flops(M, cell.model, cell.stack_sizes(
        r["capacity"]), traffic["spec"], cell.n_sample, traffic["eval_batch"],
        doc["lora"]["rank"]) for r in win.rounds)
    del mod.SEEN[:]
    records = cap.records()
    ref = follow(cell.reference, cell.model, traffic, cell.params, cell.lora0,
                 cell.corpus, 6, records)
    assert set(mod.SEEN) == {"tagged_moe"} and mod.SEEN
    nums = check.numbers(records, ref)
    limits = check.load_limits(toy_bench.here, "granite-moe-1b.fedit")
    assert check.judge(nums, limits)[0], nums


@pytest.mark.parametrize("name", ["nope", "../model", "Model", "__init__",
                                  None])
def test_an_unknown_reference_raises(toy_bench, name):
    doc = {"name": "x"} if name is None else {"name": "x", "reference": name}
    with pytest.raises(ValueError, match="reference module"):
        toy_bench.reference(doc)
    with pytest.raises(ValueError, match="reference module"):
        module_for(doc)


@pytest.mark.parametrize("config", ["granite-moe-1b-a400m", "jamba-v0.1-8l"])
def test_each_configuration_names_model_py(config):
    bench = Bench()
    assert bench.config(config)["reference"] == "model"
    assert bench.reference(bench.config(config)) is M


#: (configuration, traffic) -> [(stack sizes of each
#: round, the parent's round_flops there)], taken on the code before the
#: FLOP count moved into reference/model.py
ROUND_FLOPS = {
    ("granite-moe-1b-a400m", "devft-k10-b16s512"): [
        ({"layers": 3}, 67576746999808.0),
        ({"layers": 6}, 101255464615936.0),
        ({"layers": 12}, 168612899848192.0),
        ({"layers": 24}, 303327770312704.0)],
    ("granite-moe-1b-a400m", "fedit-k10-b16s512"):
        [({"layers": 24}, 303327770312704.0)] * 4,
    ("jamba-v0.1-8l", "devft-k10-b16s512"): [
        ({"mamba_mlp": 1, "mamba_moe": 1, "attn_mlp": 1}, 825815042359296.0),
        ({"mamba_mlp": 1, "mamba_moe": 1, "attn_mlp": 1}, 825815042359296.0),
        ({"mamba_mlp": 2, "mamba_moe": 1, "attn_mlp": 1}, 1014857325346816.0),
        ({"mamba_mlp": 3, "mamba_moe": 4, "attn_mlp": 1},
         2126163344359424.0)],
    ("jamba-v0.1-8l", "fedit-k10-b16s512"):
        [({"mamba_mlp": 3, "mamba_moe": 4, "attn_mlp": 1},
          2126163344359424.0)] * 4,
}
BASE = {"granite-moe-1b-a400m": {"layers": 24},
        "jamba-v0.1-8l": {"mamba_mlp": 3, "mamba_moe": 4, "attn_mlp": 1}}


@pytest.mark.parametrize("config,traffic", sorted(ROUND_FLOPS))
def test_round_flops_equal_the_parents(config, traffic):
    bench = Bench()
    doc, tr = bench.config(config), bench.traffic(traffic)
    sp = tr["spec"]
    n_sample = max(1, int(sp["n_clients"] * sp["sample_frac"]))
    got = []
    for _, cap in stage_plan(doc["model"], sp):
        sizes = RD.stack_capacities(BASE[config], cap) \
            if sp["method"] == "devft" else dict(BASE[config])
        got.append((sizes, round_flops(bench.reference(doc), doc["model"],
                                       sizes, sp, n_sample, tr["eval_batch"],
                                       doc["lora"]["rank"])))
    assert got == ROUND_FLOPS[(config, traffic)]


#: (cell, submodel, control) -> (hex of the loss with aux, of the loss, the
#: digest of the LoRA gradients' bytes), taken on the code before the move
LOSS = {
    ("granite-moe-1b.devft", "full", False): (
        "0x1.60f8420000000p+2", "0x1.60ae1a0000000p+2",
        "3493da0f1c0f73a22050732abfd59449"),
    ("granite-moe-1b.devft", "fused", False): (
        "0x1.61f7360000000p+2", "0x1.61c0b40000000p+2",
        "e31c3efe8b0f9a40e84c57e1116eb5d9"),
    ("granite-moe-1b.devft", "full", True): (
        "0x1.6174c40000000p+2", "0x1.612ada0000000p+2",
        "d69ca7b671882b0c6c0b583f0d68a740"),
    ("jamba-8l.devft", "full", False): (
        "0x1.7ec93c0000000p+2", "0x1.7e870e0000000p+2",
        "ac4d2658bfc91757a227fadc8ecd3597"),
    ("jamba-8l.devft", "fused", False): (
        "0x1.7f22a20000000p+2", "0x1.7ef0420000000p+2",
        "8de3ac43ac61677f01544d11c720785e"),
    ("jamba-8l.devft", "full", True): (
        "0x1.7f03b20000000p+2", "0x1.7ec13c0000000p+2",
        "0422f204ea8ec6bb6d289dc79790434a"),
}


def _digest(tree) -> str:
    h = hashlib.sha256()
    for t in _leaves(tree):
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("workload,sub,quantize", sorted(LOSS))
def test_loss_and_gradients_bit_equal_the_parents(toy_bench, workload, sub,
                                                  quantize):
    """The toy granite and jamba (f32 weights from seed 11), the whole
    model and one with layers 0 and 1 fused, and the float8 control."""
    doc = toy_bench.workload(workload)
    cfg_doc = toy_bench.config(doc["config"])
    traffic = toy_bench.traffic(doc["traffic"])
    cell = toy_bench.runner(traffic).Cell(
        cfg_doc, toy_bench.reference(cfg_doc), traffic, 11, "cpu", {})
    groups = {n: [[i] for i in range(k)] for n, k in cell.sizes.items()}
    lora = cell.lora0
    if sub == "fused":
        groups = {n: [[0, 1]] + [[i] for i in range(2, k)] if k > 1
                  else [[0]] for n, k in cell.sizes.items()}
        lora = RD.fuse_lora(lora, groups, 0.1)
    gen = torch.Generator().manual_seed(5)
    lora = {n: {p: {k: v + 0.01 * torch.randn(v.shape, generator=gen)
                    for k, v in ab.items()} for p, ab in st.items()}
            for n, st in lora.items()}
    batch = D.client_steps(cell.corpus, 11, 0, 3, 0, 1, 2, 16)[0]
    ref = cell.reference.Model(cell.model, cell.params, beta=0.1,
                               quantize=quantize)
    with torch.no_grad():
        total, loss = ref.loss(groups, lora, batch)
    loss_g, g = M.grads(ref, groups, lora, batch)
    assert (float(total).hex(), float(loss).hex(), _digest(g)) \
        == LOSS[(workload, sub, quantize)]
    assert loss_g == float(loss)
