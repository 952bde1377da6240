"""The port's four examples (``examples/torch_*.py``) against the JAX
package's examples, run live on the same inputs, which cross from JAX to
torch through ``repro_torch.interop``.

* quickstart at 2 rounds: the ``RoundLog`` trajectory held by
  ``test_torch_runner.check_trajectory`` (integer fields exactly, eval
  loss and the rest at rel = abs = 1e-3, the final LoRA as there) and
  the comm totals exactly equal.
* stage anatomy on the example's own model (seed 0): W within 1e-5 of
  JAX's; the submodel depths exactly equal, the DBLF error at most 1e-6
  and the transfer broadcast correct. The groups: the port's clustering
  of JAX's own W gives JAX's groups at capacities 2 and 4, and the
  example's groups are those of the exact (f64) W. At capacity 2 they
  are JAX's. At capacity 4 they are not: W is near-constant (off the
  diagonal 0.179-0.184; the Laplacian's eigen-gap at 4 is 1.4e-3), and
  JAX's f32 W, 3.5e-7 from the f64 one, moves a k-means boundary that
  the f64 W and the port's f32 W (2.6e-6 from it) leave in place:
  [[0, 1, 7], [2, 6], [3], [4, 5]] against [[0, 2, 6], [1, 7], [3],
  [4, 5]].
* serve_adapter on qwen2-7b and granite-moe-1b-a400m from JAX's
  ``PRNGKey(0)`` params, rank-16 LoRA and prompts: the generated tokens
  of the adapter run and the merged run both exactly equal to those of
  JAX's own ``decode_step`` loop; adapter and merged logits within 1e-6
  of the logits' largest magnitude (B is zero, so only the order of a
  sum can differ); with a nonzero B drawn here, within ``MERGED_TOL``
  (``merge_lora`` adds A·B to W before the product, the adapter run
  after it: f32 rounding only).
* the ~100M run: ``build_spec``'s JSON and hash and the parameter count
  exactly JAX's; DevFT and FedIT on a shrunk spec (3 rounds, K=1, 2
  layers of d 64) held as quickstart is, through the example's own
  ``sweep`` (JAX's initial trees handed in by patching the sweep's
  ``run_experiment`` here).
* plumbing: each example module, imported in a fresh interpreter,
  brings no ``jax``, ``ml_dtypes`` or ``repro`` module with it;
  ``main(["--device", "cpu", ...])`` runs; ``--device cuda`` without a
  card exits non-zero.
"""
import argparse
import dataclasses
import functools
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core import build_submodel as jax_build_submodel
from repro.core.grouping import layer_vectors as jax_layer_vectors
from repro.core.grouping import similarity_matrix as jax_similarity_matrix
from repro.experiments import get_preset as jax_get_preset
from repro.experiments import run_experiment as jax_run_experiment
from repro.experiments import sweep as jax_sweep
from repro.launch.specs import param_specs as jax_param_specs
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_config, reduce_config, shared_fields
from repro_torch.core.grouping import spectral_grouping
from repro_torch.lora import merge_lora

from test_torch_runner import check_trajectory

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_stage_anatomy", "torch_serve_adapter",
            "torch_federated_finetune_100m")
#: adapter vs merged logits with a nonzero B, relative to the logits'
#: largest magnitude (1.2e-6 on qwen2-7b and 1.5e-6 on granite measured on
#: the CPU: f32 rounding of W + s·A·B against x·W + s·(x·A)·B)
MERGED_TOL = 1e-5


def load(name):
    """``examples/<name>.py`` (the port's or the JAX package's) as a
    module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_port(tree):
    return interop.from_numpy_tree(jax.tree.map(np.asarray, tree))


def jax_initial_trees(jspec):
    """The JAX round engine's own initial (params, lora) for ``jspec``
    (no pretraining): f32 params from ``PRNGKey(seed)``, the LoRA from
    its ``fold_in(., 1)``."""
    cfg = jspec.build_cfg()
    key = jax.random.PRNGKey(jspec.seed)
    params = JT.init_params(cfg, key, jnp.float32)
    lora = JT.init_lora(cfg, jax.random.fold_in(key, 1),
                        rank=jspec.lora_rank)
    return to_port(params), to_port(lora)


def comm_total(logs):
    return sum(l.comm_bytes_up + l.comm_bytes_down for l in logs)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_matches_jax(capsys):
    qs = load("torch_quickstart")
    jspec = jax_get_preset("quickstart").replace(rounds=2)
    pspec = qs.build_spec(2)
    assert pspec.to_json() == jspec.to_json()
    want = jax_run_experiment(jspec)
    params, lora = jax_initial_trees(jspec)
    got = qs.run(pspec, device="cpu", params=params, lora=lora)
    check_trajectory(got, want)
    assert comm_total(got.logs) == comm_total(want.logs)
    out = capsys.readouterr().out
    assert f"final loss {got.logs[-1].eval_loss:.4f}" in out
    assert out.count("| uplink ") == 2


# ---------------------------------------------------------------------------
# stage anatomy
# ---------------------------------------------------------------------------


def test_stage_anatomy_matches_jax():
    sa = load("torch_stage_anatomy")
    cfg = dataclasses.replace(
        jax_reduce_config(jax_get_config("llama2-7b-proxy")), n_layers=8)
    # the JAX example's own trees: one key for both
    key = jax.random.PRNGKey(0)
    params = JT.init_params(cfg, key, jnp.float32)
    lora = JT.init_lora(cfg, key, rank=4)
    pcfg = sa.build_model("cpu")[0]
    assert shared_fields(pcfg) == dataclasses.asdict(cfg)

    got = sa.anatomy(pcfg, to_port(params), to_port(lora))
    vecs = np.asarray(jax_layer_vectors(params["blocks"]["layers"],
                                        lora["layers"]))
    w = np.asarray(jax_similarity_matrix(vecs))
    np.testing.assert_allclose(got["w"], w, rtol=0, atol=1e-5)
    unit = vecs.astype(np.float64)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    w_exact = unit @ unit.T
    assert sorted(got["stages"]) == list(sa.CAPACITIES) == [2, 4]
    for cap, st in got["stages"].items():
        sub = jax_build_submodel(cfg, params, lora, cap, beta=sa.BETA)
        want = sub.plan["layers"]["groups"]
        # the clustering is the JAX package's: on JAX's W, JAX's groups
        assert spectral_grouping(w, cap) == want, cap
        # the port's W groups the layers as the exact W does
        assert st["groups"] == spectral_grouping(w_exact, cap), cap
        if cap == 2:
            assert st["groups"] == want
        assert st["depth"] == jax.tree.leaves(
            sub.params["blocks"]["layers"])[0].shape[0] == cap
        assert st["dblf_err"] <= 1e-6
        assert st["broadcast"] is True


# ---------------------------------------------------------------------------
# serve_adapter
# ---------------------------------------------------------------------------


def jax_generated(cfg, params, lora, prompts, gen=16):
    """The JAX example's decode loop (``bench_decode``), returning the
    generated tokens (B, gen) instead of its time."""
    batch, prompt = prompts.shape
    cache = JT.init_cache(cfg, batch, prompt + gen, jnp.float32)
    step = jax.jit(lambda p, lo, t, c: JT.decode_step(cfg, p, lo, t, c))
    tok, out = prompts[:, :1], []
    for t in range(prompt + gen - 1):
        logits, cache = step(params, lora, tok, cache)
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        if t + 1 < prompt:
            tok = prompts[:, t + 1: t + 2]
        else:
            tok = nxt
            out.append(np.asarray(nxt))
    return np.concatenate(out, 1)


def _row_scaled(a, b, vocab):
    """max |a - b| over the live vocabulary, over max |b| there."""
    a, b = a[..., :vocab], b[..., :vocab]
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_serve_adapter_matches_jax(arch):
    sv = load("torch_serve_adapter")
    jcfg = jax_reduce_config(jax_get_config(arch))
    key = jax.random.PRNGKey(0)
    params = JT.init_params(jcfg, key, jnp.float32)
    lora = JT.init_lora(jcfg, key, rank=16)
    prompts = jax.random.randint(key, (4, 16), 0, jcfg.vocab)
    want = jax_generated(jcfg, params, lora, prompts)

    cfg = reduce_config(get_config(arch))
    p_params, p_lora = to_port(params), to_port(lora)
    p_prompts = torch.from_numpy(np.array(prompts))
    got = sv.serve(arch, cfg, p_params, p_lora, p_prompts, device="cpu")
    for run in ("adapter", "merged"):
        sec, tokens, logits = got[run]
        assert sec > 0
        assert tokens.shape == (4, 16)
        np.testing.assert_array_equal(tokens.numpy(), want)
        assert logits.shape == (4, 31, cfg.padded_vocab)
    assert _row_scaled(got["adapter"][2], got["merged"][2], cfg.vocab) <= 1e-6

    # a trained adapter: B nonzero, merged into W before the product
    rng = np.random.default_rng(0)
    trained = interop.tree_map(
        lambda t: torch.from_numpy(rng.normal(0.0, 0.05, tuple(t.shape))
                                   .astype(np.float32)), p_lora)
    trained = {name: {tgt: {"a": ab["a"], "b": trained[name][tgt]["b"]}
                      for tgt, ab in stack.items()}
               for name, stack in p_lora.items()}
    _, tok_a, logits_a = sv.bench_decode(cfg, p_params, trained, p_prompts,
                                         device="cpu")
    _, tok_m, logits_m = sv.bench_decode(cfg, merge_lora(p_params, trained),
                                         None, p_prompts, device="cpu")
    assert _row_scaled(logits_m, logits_a, cfg.vocab) <= MERGED_TOL
    assert not torch.equal(tok_a, torch.from_numpy(want))   # B moved them


# ---------------------------------------------------------------------------
# the ~100M run
# ---------------------------------------------------------------------------


def test_100m_spec_and_param_count_match_jax():
    jfed = load("federated_finetune_100m")
    pfed = load("torch_federated_finetune_100m")
    args = argparse.Namespace(rounds=30, k_local=5, seq=64)
    jspec, pspec = jfed.build_spec(args), pfed.build_spec(args)
    assert pspec.to_json() == jspec.to_json()
    assert pspec.spec_hash() == jspec.spec_hash()
    n = sum(math.prod(l.shape)
            for l in jax.tree.leaves(jax_param_specs(jspec.build_cfg())))
    assert pfed.param_count(pspec.build_cfg()) == n


#: the test-only shrink of the ~100M spec: 2 layers of d 64, 3 rounds
#: of K=1 local step over 16 tokens; DevFT's capacities 1, 2, 2 (at 2
#: rounds both packages put both rounds in the last stage, so DevFT
#: would equal FedIT)
SHRUNK = dict(reduced={"n_layers": 2, "d_model": 64, "n_heads": 4,
                       "n_kv_heads": 4, "d_ff": 128, "vocab": 256},
              layers=2, rounds=3, k_local=1, seq=16)


def test_100m_sweep_matches_jax(monkeypatch, tmp_path, capsys):
    pfed = load("torch_federated_finetune_100m")
    args = argparse.Namespace(rounds=30, k_local=5, seq=64)
    pbase = pfed.build_spec(args).replace(**SHRUNK)
    jbase = load("federated_finetune_100m").build_spec(
        args).replace(**SHRUNK)
    want = {r.spec.method: r
            for r in jax_sweep(jbase, {"method": ["devft", "fedit"]})}
    params, lora = jax_initial_trees(jbase)
    sweep_mod = importlib.import_module("repro_torch.experiments.sweep")
    monkeypatch.setattr(sweep_mod, "run_experiment", functools.partial(
        sweep_mod.run_experiment, params=params, lora=lora))
    got = pfed.run(pbase, ["devft", "fedit"], device="cpu", out=tmp_path)
    assert [r.spec.method for r in got] == ["devft", "fedit"]
    assert [l.capacity for l in got[0].logs] == [1, 2, 2]
    for res in got:
        check_trajectory(res, want[res.spec.method])
        assert comm_total(res.logs) == comm_total(want[res.spec.method].logs)
    saved = json.loads((tmp_path / "federated_100m_torch.json").read_text())
    assert sorted(saved) == ["devft", "fedit"]
    assert saved["devft"]["comm_MB"] < saved["fedit"]["comm_MB"]
    out = capsys.readouterr().out
    assert "DEVFT vs FedIT: comm x" in out


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------


_ISOLATION = """
import importlib.util, sys
for name in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(name, f"examples/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(bad)
assert not bad, bad
"""


def test_examples_import_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", _ISOLATION, *EXAMPLES],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name, argv, printed", [
    ("torch_quickstart", ["--rounds", "1"], "final loss"),
    ("torch_stage_anatomy", [], "broadcast correct: True"),
    ("torch_serve_adapter", ["--arch", "mamba2-2.7b"], "per-token decode"),
    # full width (83M params), one round of FedIT over 2 x 16 tokens
    ("torch_federated_finetune_100m", ["--rounds", "1", "--k-local", "1",
                                       "--seq", "16", "--method", "fedit"],
     "-> 83M params"),
])
def test_main_runs_on_cpu(name, argv, printed, capsys, tmp_path):
    if name == "torch_federated_finetune_100m":
        argv = [*argv, "--out", str(tmp_path)]
    load(name).main(["--device", "cpu", *argv])
    assert printed in capsys.readouterr().out


@pytest.mark.parametrize("name", EXAMPLES)
def test_device_cuda_without_a_card_exits_nonzero(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        load(name).main(["--device", "cuda"])
    assert e.value.code not in (0, None)
