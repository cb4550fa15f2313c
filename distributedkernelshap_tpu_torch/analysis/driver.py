"""Analyzer driver of the port: file walking, suppression, the one lint
entry point (the port's copy of the JAX package's ``analysis/driver.py``).

Scope: the three static families (concurrency, torch contract, serving
ladder) run over every ``.py`` module under
``distributedkernelshap_tpu_torch/`` (production code; benchmarks and
tests are load-generating harnesses with their own deliberate thread
churn -- they stay covered by the runtime lockwitness and the test suite,
not by the concurrency model).  The ladder contract additionally reads its
fixed artifact files by repo-relative path.  Findings are suppressed by
inline pragmas and the port's own ``analysis/baseline.toml``.

``scripts/torch_lint.py`` is the CLI and the unified gate.
"""

import ast
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from distributedkernelshap_tpu_torch.analysis import concurrency, ladder, \
    torch_contract
from distributedkernelshap_tpu_torch.analysis.core import (
    BaselineEntry,
    Finding,
    apply_suppressions,
    load_baseline,
)

#: package subtree the concurrency/torch-contract families scan
PACKAGE_DIR = "distributedkernelshap_tpu_torch"
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache"}

DEFAULT_BASELINE = os.path.join(PACKAGE_DIR, "analysis", "baseline.toml")


@dataclass
class LintResult:
    active: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale_baseline: List[BaselineEntry] = field(default_factory=list)
    parse_errors: List[str] = field(default_factory=list)
    files_scanned: int = 0
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.active and not self.stale_baseline \
            and not self.parse_errors


def package_sources(root: str,
                    package_dir: str = PACKAGE_DIR) -> Dict[str, str]:
    """``{repo-relative path: source text}`` for the scanned subtree."""

    sources: Dict[str, str] = {}
    base = os.path.join(root, package_dir)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as fh:
                sources[rel] = fh.read()
    return sources


def lint_repo(root: str, baseline_path: Optional[str] = None,
              package_dir: str = PACKAGE_DIR) -> LintResult:
    """Run all three analyzer families over the tree at ``root``."""

    t0 = time.monotonic()
    result = LintResult()
    sources = package_sources(root, package_dir)
    result.files_scanned = len(sources)
    raw: List[Finding] = []
    for rel, src in sources.items():
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            result.parse_errors.append(f"{rel}: {e}")
            continue
        raw.extend(concurrency.check_module(tree, rel))
        raw.extend(torch_contract.check_module(tree, rel))
    raw.extend(ladder.check_ladder(root, sources))
    if baseline_path is None:
        baseline_path = os.path.join(root, DEFAULT_BASELINE)
    baseline = load_baseline(baseline_path)
    active, suppressed, stale = apply_suppressions(raw, sources, baseline)
    result.active = sorted(active, key=lambda f: (f.file, f.line,
                                                  f.check_id))
    result.suppressed = suppressed
    result.stale_baseline = stale
    result.elapsed_s = time.monotonic() - t0
    return result
