"""Shared analyzer plumbing: findings, pragmas, the committed baseline.

A finding is ``(check_id, file, line, symbol, message, hint)``.  Two
suppression channels exist, both explicit and reviewable:

* an inline pragma ``# dks: allow(DKS-C001)`` on the flagged line or the
  line directly above it (several ids may be comma-separated; an optional
  trailing ``: reason`` documents why);
* a committed ``analysis/baseline.toml`` of pre-existing accepted
  findings, matched on ``(id, file, symbol)``.  Baseline entries that no
  longer match anything are themselves a failure (drift: the accepted
  debt was paid, so the entry must go) — new findings always fail.

``baseline.toml`` is parsed by a deliberately tiny TOML-subset reader
(``[[finding]]`` tables of ``key = "value"`` pairs): the container python
is 3.10 (no ``tomllib``) and the analyzer must stay dependency-free.
"""

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

#: inline suppression pragma; ids comma-separated, optional `: reason`
PRAGMA_RE = re.compile(r"#\s*dks:\s*allow\(\s*([A-Z0-9,\s-]+?)\s*\)")


@dataclass(frozen=True)
class Finding:
    """One analyzer hit, carrying everything the driver needs to render
    ``file:line: CHECK-ID [symbol] message (fix: hint)`` and everything
    suppression needs to match on."""

    check_id: str
    file: str          # repo-relative path
    line: int
    symbol: str        # e.g. "Autoscaler.ticks_total" or "Engine._fn"
    message: str
    hint: str = ""

    def render(self) -> str:
        out = f"{self.file}:{self.line}: {self.check_id} [{self.symbol}] " \
              f"{self.message}"
        if self.hint:
            out += f" (fix: {self.hint})"
        return out


def suppressed_lines(source: str) -> Dict[int, Set[str]]:
    """``{line_number: {check ids allowed on that line}}``.  A pragma
    covers its own line and the line below it, so both styles work::

        self.x += 1  # dks: allow(DKS-C001)

        # dks: allow(DKS-C005): deliberate fail-fast, see comment
        while not stop.is_set():
    """

    allowed: Dict[int, Set[str]] = {}
    for lineno, line in enumerate(source.splitlines(), 1):
        m = PRAGMA_RE.search(line)
        if not m:
            continue
        ids = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
        for covered in (lineno, lineno + 1):
            allowed.setdefault(covered, set()).update(ids)
    return allowed


@dataclass
class BaselineEntry:
    id: str
    file: str
    symbol: str = ""     # empty = any symbol in the file
    justification: str = ""
    matched: bool = field(default=False, compare=False)

    def matches(self, f: Finding) -> bool:
        return (self.id == f.check_id and self.file == f.file
                and (not self.symbol or self.symbol == f.symbol))


_KV_RE = re.compile(r'^\s*([A-Za-z_]+)\s*=\s*"(.*)"\s*$')


def load_baseline(path: str) -> List[BaselineEntry]:
    """Parse ``analysis/baseline.toml`` (the ``[[finding]]`` subset; see
    module doc).  Missing file = empty baseline.  Malformed lines raise —
    a baseline that silently half-parses would silently un-suppress."""

    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except FileNotFoundError:
        return []
    entries: List[BaselineEntry] = []
    current: Optional[dict] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[finding]]":
            if current is not None:
                entries.append(BaselineEntry(**current))
            current = {"id": "", "file": ""}
            continue
        m = _KV_RE.match(line)
        if m is None:
            raise ValueError(
                f"{path}:{lineno}: unparseable baseline line {line!r} "
                f"(expected [[finding]] or key = \"value\")")
        if current is None:
            raise ValueError(
                f"{path}:{lineno}: key outside a [[finding]] table")
        key, value = m.group(1), m.group(2)
        if key not in ("id", "file", "symbol", "justification"):
            raise ValueError(f"{path}:{lineno}: unknown baseline key "
                             f"{key!r}")
        current[key] = value
    if current is not None:
        entries.append(BaselineEntry(**current))
    for e in entries:
        if not e.id or not e.file:
            raise ValueError(f"{path}: baseline entry missing id/file: {e}")
    return entries


def apply_suppressions(
        findings: List[Finding],
        sources: Dict[str, str],
        baseline: List[BaselineEntry],
) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """Split raw findings into ``(active, suppressed, stale_baseline)``.

    ``sources`` maps repo-relative path -> file text (for pragma scan).
    Every baseline entry must match at least one finding; unmatched
    entries come back as ``stale_baseline`` and the driver fails on them
    (drift), so the accepted-debt list can only shrink honestly.
    """

    pragma_cache: Dict[str, Dict[int, Set[str]]] = {}
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if f.file in sources:
            if f.file not in pragma_cache:
                pragma_cache[f.file] = suppressed_lines(sources[f.file])
            if f.check_id in pragma_cache[f.file].get(f.line, ()):
                suppressed.append(f)
                continue
        entry = next((e for e in baseline if e.matches(f)), None)
        if entry is not None:
            entry.matched = True
            suppressed.append(f)
            continue
        active.append(f)
    stale = [e for e in baseline if not e.matched]
    return active, suppressed, stale
