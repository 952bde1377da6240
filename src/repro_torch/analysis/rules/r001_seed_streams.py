"""R001 — seed streams must be keyed, never arithmetic (the JAX
package's rule, the same detectors).

Two detectors:

* arithmetic on a seed-named value (``seed * 10_000 + rnd``,
  ``seed + 9_999``, ``args.seed * 7919``): composite streams derived by
  integer arithmetic collide across base seeds — seed 0's round 10_000
  IS seed 1's round 0. The JAX package once shipped exactly this in
  its round-batch seeds; the rule stops it coming back anywhere. A seed-named operand
  inside ``torch.Generator(...).manual_seed(<expr>)`` is caught here
  too: the arithmetic is the same whichever generator it seeds.
* a raw ``np.random.RandomState(...)`` / ``np.random.default_rng(...)``
  constructor outside ``data/synthetic.py`` (the ``keyed_rng`` home):
  every deterministic stream must derive through ``SeedSequence`` tuple
  entropy (``keyed_rng`` / ``client_rng``) so subsystems can never
  silently share or collide streams.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.context import ModuleContext, call_name
from repro_torch.analysis.registry import rule

ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
             ast.Mod, ast.Pow, ast.LShift, ast.RShift,
             ast.BitXor, ast.BitOr, ast.BitAnd)

# keyed_rng / client_rng live here; raw RandomState inside is the recipe
RNG_HOME = ("data/synthetic.py",)

# trees where a raw throwaway RNG is legitimate: tests and benchmarks
# build fixture noise that never feeds a persisted stream. The
# seed-ARITHMETIC detector still applies there — a colliding stream in
# a test fixture corrupts goldens just as surely as in src.
RAW_RNG_EXEMPT_TREES = ("tests/", "benchmarks/")

RAW_RNG_CALLS = ("np.random.RandomState", "numpy.random.RandomState",
                 "random.RandomState",
                 "np.random.default_rng", "numpy.random.default_rng")

HINT = ("derive the stream from SeedSequence tuple entropy: "
        "repro_torch.data.synthetic.keyed_rng(seed, label, ...) / "
        "client_rng((seed, rnd), client); seed a torch.Generator "
        "with the seed itself or a keyed_rng draw, never "
        "manual_seed(seed * k + i)")


def _seedish(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return "seed" in node.id.lower()
    if isinstance(node, ast.Attribute):
        return "seed" in node.attr.lower()
    return False


def _contains_seed(node: ast.AST) -> bool:
    return any(_seedish(n) for n in ast.walk(node))


@rule("R001", name="keyed-seed-streams",
      summary="seed-derived RNG streams must use SeedSequence tuple "
              "entropy, not seed arithmetic or raw RandomState",
      hint=HINT,
      history="the JAX package once derived round-batch seeds as "
              "`seed * 10_000 + rnd`, which collided across base seeds, "
              "and shared one RandomState, which made client batches "
              "depend on cohort order")
def check(ctx: ModuleContext):
    findings = []

    def visit(node: ast.AST):
        # outermost arithmetic expression only: one finding per site
        if isinstance(node, ast.BinOp) and isinstance(node.op, ARITH_OPS) \
                and _contains_seed(node):
            findings.append(ctx.finding(
                "R001", node,
                "arithmetic on a seed ('seed*k+x'-style stream "
                "derivation collides across base seeds)", HINT))
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(ctx.tree)

    if not ctx.path_endswith(*RNG_HOME) \
            and not ctx.path.startswith(RAW_RNG_EXEMPT_TREES):
        for node in ctx.walk():
            if isinstance(node, ast.Call) \
                    and call_name(node) in RAW_RNG_CALLS:
                findings.append(ctx.finding(
                    "R001", node,
                    "raw RandomState/default_rng constructor outside "
                    "data/synthetic.py", HINT))
    return findings
