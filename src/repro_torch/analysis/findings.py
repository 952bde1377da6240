"""Findings and the committed baseline (the JAX package's
``repro.analysis.findings``, the same format: a baseline either package
writes is read by the other).

A :class:`Finding` is one rule violation at one source location. Its
baseline identity is ``(rule, path, line_text)`` — the *stripped source
line*, not the line number — so grandfathered findings survive
unrelated edits that shift lines, while any edit to the offending line
itself un-grandfathers it.

The baseline file is JSON: ``{"version": 1, "findings": [{"rule",
"path", "line_text", "count"}, ...]}``. ``count`` handles several
identical lines in one file (each entry suppresses at most ``count``
matching findings; extras are reported). ``apply_baseline`` returns the
kept findings plus the *stale* baseline entries — entries that matched
nothing, which the CLI treats as an error so the baseline can only
shrink.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from typing import Dict, Iterable, List, Tuple

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # "R001"
    path: str          # repo-root-relative posix path when possible
    line: int          # 1-based
    col: int           # 0-based
    message: str
    hint: str = ""     # how to fix
    line_text: str = ""  # stripped offending source line

    @property
    def key(self) -> Tuple[str, str, str]:
        """Baseline identity (line numbers drift; line text pins)."""
        return (self.rule, self.path, self.line_text)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col + 1}"
        out = f"{loc}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    fix: {self.hint}"
        return out


# ---------------------------------------------------------------------------
# baseline I/O
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> Dict[Tuple[str, str, str], int]:
    """-> {(rule, path, line_text): count}."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{doc.get('version')!r} "
                         f"(expected {BASELINE_VERSION})")
    out: Dict[Tuple[str, str, str], int] = {}
    for e in doc["findings"]:
        key = (e["rule"], e["path"], e["line_text"])
        out[key] = out.get(key, 0) + int(e.get("count", 1))
    return out


def save_baseline(findings: Iterable[Finding], path: str) -> None:
    """Write the baseline that grandfathers exactly ``findings``."""
    counts = Counter(f.key for f in findings)
    doc = {
        "version": BASELINE_VERSION,
        "findings": [
            {"rule": rule, "path": p, "line_text": text, "count": n}
            for (rule, p, text), n in sorted(counts.items())
        ],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def apply_baseline(
    findings: List[Finding],
    baseline: Dict[Tuple[str, str, str], int],
) -> Tuple[List[Finding], List[Finding], List[Tuple[str, str, str]]]:
    """-> (kept, suppressed, stale_baseline_keys).

    Each baseline entry suppresses at most ``count`` matching findings
    — nothing else. Entries that matched no finding come back as
    ``stale`` so a fixed violation cannot linger in the baseline.
    """
    budget = dict(baseline)
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            suppressed.append(f)
        else:
            kept.append(f)
    stale = sorted(k for k, n in budget.items() if n > 0)
    return kept, suppressed, stale
