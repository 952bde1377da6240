"""The port's static-analysis layer (``repro_torch.analysis``): one
firing and one passing snippet per rule (R001, R002 in Python and in
CUDA, R006 on ``torch.autograd.Function``, R010), the baseline's
semantics, the committed baseline over ``src/repro_torch``, the CLI, and
parity with the JAX package's layer: the same framework-free snippets
give the same ``(rule, line, col)`` findings in both, and a baseline
written by either package is read by the other."""
import json

import pytest
import torch

import repro.analysis as jax_analysis
from repro_torch.analysis import (
    DEFAULT_BASELINE,
    DEFAULT_TARGET,
    all_rules,
    analyze_paths,
    analyze_source,
    apply_baseline,
    get_rule,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.__main__ import render_github
from repro_torch.analysis.findings import Finding

pytestmark = pytest.mark.analysis

torch.set_num_threads(1)

PATH = "src/repro_torch/somewhere/module.py"   # generic non-exempt location
CU_PATH = "src/repro_torch/kernels/csrc/some_kernel.cu"


def _hits(src, rule_id, path=PATH):
    return analyze_source(src, path, rules=[rule_id])


# ---------------------------------------------------------------------------
# rules: firing / passing
# ---------------------------------------------------------------------------


def test_r001_flags_seed_arithmetic_and_raw_rng():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def streams(seed, rnd):\n"
        "    s = seed * 10_000 + rnd\n"
        "    rng = np.random.RandomState(seed)\n"
        "    g = torch.Generator().manual_seed(cfg.seed + rnd)\n"
        "    return s, rng, g\n"
    )
    found = _hits(src, "R001")
    assert [f.line for f in found] == [4, 5, 6]
    assert all(f.rule == "R001" for f in found)


def test_r001_keyed_streams_and_rng_home_pass():
    clean = (
        "import torch\n"
        "from repro_torch.data.synthetic import keyed_rng\n"
        "def streams(seed, rnd):\n"
        "    g = torch.Generator().manual_seed(seed)\n"
        "    return keyed_rng(seed, 'cohort', rnd), g\n"
    )
    assert _hits(clean, "R001") == []
    home = ("import numpy as np\n"
            "rng = np.random.RandomState(np.random.MT19937(ss))\n")
    assert _hits(home, "R001",
                 path="src/repro_torch/data/synthetic.py") == []


def test_r002_flags_raw_masking_constants():
    src = (
        "import torch\n"
        "a = torch.where(mask, s, -1e9)\n"
        "b = torch.where(mask, s, -torch.inf)\n"
        "c = torch.where(mask, s, float('-inf'))\n"
    )
    assert [f.line for f in _hits(src, "R002")] == [2, 3, 4]


def test_r002_neg_inf_and_common_py_pass():
    clean = (
        "from repro_torch.kernels.common import NEG_INF\n"
        "import torch\n"
        "a = torch.where(mask, s, NEG_INF)\n"
        "b = x - 65504.0\n"
    )
    assert _hits(clean, "R002") == []
    home = "NEG_INF = -1e30\n"
    assert _hits(home, "R002",
                 path="src/repro_torch/kernels/common.py") == []


CU_CLEAN = (
    "// a fully masked row: -1e30 here is a comment, -INFINITY too\n"
    "constexpr float kNegInf = -1e30f;  // = NEG_INF\n"
    "/* -FLT_MAX in a block comment */\n"
    "__device__ float f(float s, bool live, float e) {\n"
    "  const char* msg = \"-inf\";\n"
    "  float tiny = 1e-30f * e, big = 3.0e9f - e, exp = 2.5e-12f;\n"
    "  return live ? s : kNegInf;\n"
    "}\n"
)


def test_r002_cuda_kneginf_comments_and_strings_pass():
    assert _hits(CU_CLEAN, "R002", path=CU_PATH) == []


def test_r002_flags_raw_constants_in_cuda():
    src = (
        "__device__ float f(float s, bool live) {\n"
        "  float a = live ? s : -1e30f;\n"
        "  float c = - FLT_MAX;\n"
        "  if (!live) s = -INFINITY;\n"
        "  return fmaxf(a, -1.0e9) + s + c;\n"
        "}\n"
    )
    found = _hits(src, "R002", path=CU_PATH)
    assert [(f.line, f.col) for f in found] == [(2, 23), (3, 12), (4, 17),
                                                (5, 18)]
    assert all(f.rule == "R002" for f in found)


def test_r002_cuda_running_max_identity_passes():
    # -inf as the online softmax's max identity is not a masking value
    src = (
        "__device__ float f(const float* s, int n) {\n"
        "  float m[2] = {-INFINITY, -CUDART_INF_F}, l = 0.f;\n"
        "  float mx = -CUDART_INF_F;\n"
        "  for (int i = 0; i < n; ++i) mx = fmaxf(mx, s[i]);\n"
        "  float ms = mx == -CUDART_INF_F ? 0.f : mx;\n"
        "  float2 v = make_float2(-CUDART_INF_F, 0.f);\n"
        "  return ms + m[0] + l + v.x;\n"
        "}\n"
    )
    assert _hits(src, "R002", path=CU_PATH) == []


def test_r002_flags_kneginf_drifting_from_neg_inf():
    drifted = CU_CLEAN.replace("kNegInf = -1e30f", "kNegInf = -1e9f")
    found = _hits(drifted, "R002", path=CU_PATH)
    assert len(found) == 1 and found[0].line == 2
    assert "differs from NEG_INF" in found[0].message


def test_python_only_rules_skip_cuda_sources():
    # a rule that reads Python only never sees a .cu source
    assert _hits("int seed2 = seed * 7 + r;\n", "R001", path=CU_PATH) == []


FN_OK = (
    "import torch\n"
    "class _Op(torch.autograd.Function):\n"
    "    @staticmethod\n"
    "    def forward(ctx, x, w, scale, backend):\n"
    "        ctx.save_for_backward(x, w)\n"
    "        return x @ w\n"
    "    @staticmethod\n"
    "    def backward(ctx, g):\n"
    "        need = ctx.needs_input_grad[:2]\n"
    "        grads = iter(compute(g))\n"
    "        return (*(next(grads) if n else None for n in need),\n"
    "                None, None)\n"
    "class _Pair(torch.autograd.Function):\n"
    "    @staticmethod\n"
    "    def forward(ctx, t, group):\n"
    "        return t, t\n"
    "    @staticmethod\n"
    "    def backward(ctx, ga, gb):\n"
    "        return ga + gb, None\n"
)


def test_r006_matched_autograd_functions_pass():
    assert _hits(FN_OK, "R006") == []
    # the port's own Functions (kernels/ops.py, models/moe.py) pass too
    assert analyze_paths([p / "kernels" / "ops.py" for p in DEFAULT_TARGET]
                         + [p / "models" / "moe.py" for p in DEFAULT_TARGET],
                         rules=["R006"]) == []


def test_r006_flags_backward_one_gradient_short():
    src = FN_OK.replace("                None, None)\n", "                None)\n")
    found = _hits(src, "R006")
    assert len(found) == 1 and found[0].line == 11
    assert "_Op.backward returns 3 gradients" in found[0].message


def test_r006_flags_backward_taking_wrong_gradient_count():
    src = FN_OK.replace("def backward(ctx, ga, gb):", "def backward(ctx, g):")
    src = src.replace("return ga + gb, None", "return g, None")
    found = _hits(src, "R006")
    assert len(found) == 1
    assert "takes 1 gradients, forward returns 2" in found[0].message


R010_CLEAN = (
    "from repro_torch.kernels.dispatch import (register_kernel,\n"
    "                                          declare_kernel_contract)\n"
    "register_kernel('my_op', 'reference', ref_fn)\n"
    "declare_kernel_contract('my_op', family='lora', out='x@w')\n"
    "@register('mymethod')\n"
    "class MyStrategy:\n"
    "    contract = AggregateContract()\n"
    "class Engine:\n"
    "    contract = StepContract()\n"
    "    def _step(self, idx, tokens, active):\n"
    "        return None\n"
)


def test_r010_declared_surfaces_pass():
    assert _hits(R010_CLEAN, "R010") == []


def test_r010_flags_engine_without_contract():
    src = R010_CLEAN.replace("    contract = StepContract()\n", "")
    found = _hits(src, "R010")
    assert len(found) == 1 and "Engine" in found[0].message
    assert "_step" in found[0].message


def test_r010_flags_undeclared_kernel_and_strategy():
    src = (R010_CLEAN.replace("declare_kernel_contract('my_op'",
                              "declare_kernel_contract('other'")
           .replace("    contract = AggregateContract()\n", "    pass\n"))
    msgs = " | ".join(f.message for f in _hits(src, "R010"))
    assert "'my_op'" in msgs and "MyStrategy" in msgs


def test_rule_registry_complete():
    assert [r.id for r in all_rules()] == ["R001", "R002", "R006", "R010"]
    for r in all_rules():
        assert r.summary and r.hint and r.history
        assert get_rule(r.id) is r
    assert get_rule("R002").languages == ("python", "cuda")


# ---------------------------------------------------------------------------
# parity with the JAX package's layer
# ---------------------------------------------------------------------------

SHARED_SNIPPETS = [
    ("R001", "import numpy as np\n"
             "def streams(seed, rnd, args):\n"
             "    a = seed * 10_000 + rnd\n"
             "    b = (args.seed + 9_999) % 7\n"
             "    c = np.random.RandomState(seed)\n"
             "    d = np.random.default_rng(0)\n"
             "    return a, b, c, d\n"),
    ("R002", "import numpy as np, math\n"
             "a = where(mask, s, -1e9)\n"
             "b = where(mask, s, float('-inf'))\n"
             "c = [-1e30, -np.inf, -math.inf, -float('inf')]\n"
             "d = x - 65504.0\n"),
]


@pytest.mark.parametrize("rule_id,src", SHARED_SNIPPETS,
                         ids=[r for r, _ in SHARED_SNIPPETS])
def test_findings_match_the_jax_package(rule_id, src):
    def where(findings):
        return [(f.rule, f.line, f.col) for f in findings]

    ours = analyze_source(src, PATH, rules=[rule_id])
    theirs = jax_analysis.analyze_source(src, PATH, rules=[rule_id])
    assert ours and where(ours) == where(theirs)
    assert [f.line_text for f in ours] == [f.line_text for f in theirs]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_baselines_read_across_packages(tmp_path, writer):
    src = SHARED_SNIPPETS[0][1] + SHARED_SNIPPETS[1][1]
    save, load = {"port": (save_baseline, jax_analysis.load_baseline),
                  "jax": (jax_analysis.save_baseline, load_baseline)}[writer]
    findings = (analyze_source(src, PATH) if writer == "port"
                else jax_analysis.analyze_source(
                    src, PATH, rules=["R001", "R002"]))
    path = tmp_path / "baseline.json"
    save(findings, str(path))
    assert load(str(path)) == load_baseline(str(path)) \
        == jax_analysis.load_baseline(str(path))
    kept, suppressed, stale = apply_baseline(
        analyze_source(src, PATH), load(str(path)))
    assert kept == [] and stale == [] and len(suppressed) == len(findings)


# ---------------------------------------------------------------------------
# baseline semantics
# ---------------------------------------------------------------------------

DIRTY = ("import numpy as np\n"
         "def streams(seed, rnd):\n"
         "    return np.random.RandomState(seed * 7 + rnd)\n")


def test_baseline_round_trip(tmp_path):
    findings = analyze_source(DIRTY, PATH, rules=["R001"])
    assert findings
    bl_path = tmp_path / "baseline.json"
    save_baseline(findings, str(bl_path))
    kept, suppressed, stale = apply_baseline(findings,
                                             load_baseline(str(bl_path)))
    assert kept == [] and stale == []
    assert [f.key for f in suppressed] == [f.key for f in findings]


def test_baseline_suppresses_only_grandfathered_and_goes_stale(tmp_path):
    old = analyze_source(DIRTY, PATH, rules=["R001"])
    bl_path = tmp_path / "baseline.json"
    save_baseline(old, str(bl_path))
    new_src = DIRTY + "extra = np.random.default_rng(0)\n"
    kept, _, stale = apply_baseline(
        analyze_source(new_src, PATH, rules=["R001"]),
        load_baseline(str(bl_path)))
    assert len(kept) == 1 and "default_rng" in kept[0].line_text
    assert stale == []
    kept2, supp2, stale2 = apply_baseline([], load_baseline(str(bl_path)))
    assert kept2 == [] and supp2 == []
    assert len(stale2) == len({f.key for f in old})


def test_baseline_count_budget(tmp_path):
    src = ("import numpy as np\n"
           "x = np.random.RandomState(0)\n"
           "x = np.random.RandomState(0)\n")
    findings = analyze_source(src, PATH, rules=["R001"])
    assert len(findings) == 2 and findings[0].key == findings[1].key
    bl_path = tmp_path / "baseline.json"
    save_baseline(findings[:1], str(bl_path))
    kept, suppressed, stale = apply_baseline(
        findings, load_baseline(str(bl_path)))
    assert len(kept) == 1 and len(suppressed) == 1 and stale == []


def test_baseline_version_check(tmp_path):
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps({"version": 99, "findings": []}))
    with pytest.raises(ValueError):
        load_baseline(str(bad))


# ---------------------------------------------------------------------------
# the port's tree under the committed baseline, and the CLI
# ---------------------------------------------------------------------------


def test_src_tree_clean_under_committed_baseline():
    findings = analyze_paths(DEFAULT_TARGET)
    baseline = load_baseline(str(DEFAULT_BASELINE))
    kept, suppressed, stale = apply_baseline(findings, baseline)
    assert kept == [], "\n".join(f.render() for f in kept)
    assert stale == []
    assert sum(baseline.values()) == len(suppressed)
    assert {f.key for f in suppressed} == set(baseline)
    # the grandfathered entries are the redesigned attention kernels'
    # -inf mask stores
    assert {k[:2] for k in baseline} <= {
        ("R002", "src/repro_torch/kernels/csrc/flash_attention.cu"),
        ("R002", "src/repro_torch/kernels/csrc/flash_decode.cu")}


def test_cli_smoke(tmp_path, capsys):
    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(r in listed for r in ("R001", "R002", "R006", "R010", "C001",
                                     "C002", "C003"))
    assert cli_main([]) == 0                       # committed baseline
    assert cli_main(["--no-baseline"]) == 1        # grandfathered shown
    f = tmp_path / "dirty.py"
    f.write_text(DIRTY)
    assert cli_main([str(f), "--rule", "R001", "--no-baseline"]) == 1
    assert cli_main([str(f), "--rule", "R002", "--no-baseline"]) == 0
    capsys.readouterr()
    assert cli_main([str(f), "--no-baseline", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [x["rule"] for x in doc["findings"]] == ["R001", "R001"]


def test_rule_filter_scopes_stale_detection(tmp_path):
    # the committed baseline holds R002 entries: a run that never runs
    # R002 treats them as out of scope, one that does reports them stale
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert cli_main([str(clean), "--rule", "R001"]) == 0
    assert cli_main([str(clean), "--rule", "R002"]) == 1


def test_github_annotations_escape_workflow_commands():
    f = Finding("C003", "src/x.py", 3, 4, "bad\nthing % here",
                line_text="serving:qwen2-7b:multi:meta")
    line = render_github(f)
    assert line.startswith("::error file=src/x.py,line=3,col=5,"
                           "title=C003::")
    assert "%0A" in line and "%25" in line and "\n" not in line
