"""Serving-ladder contract lint (``DKS-L0xx``), the port's copy of the JAX
package's ``analysis/ladder.py`` over the port's own artifacts.

PRs 7, 9, 10 and 12 each hand-built the same serving "ladder" for a new
engine path — a dispatch entry, a fingerprint-keyed X-independent consts
cache, a warmup rung signature, a ``dks_serve_explain_path_total`` label
and a fallback counter family — and review caught a missing rung every
time.  This lint pins the contract: for every path name in
``registry/classify.ENGINE_PATHS``, the full rung must exist statically,
so the next exact family (quadratic/GAM, ROADMAP item 4) cannot land
half-wired.

Known paths carry an audited :data:`RUNG_SPECS` entry (their artifact
names predate the lint).  A NEW path name gets the derived default —
``_dispatch_<p>``, ``_<p>_consts``, serve label ``<p>``,
``dks_<p>_fallback_total`` — and the lint fails until each artifact
lands (or the spec table is extended with audited aliases as part of the
same review).

Checks:

* ``DKS-L001`` — engine dispatch entry (``_dispatch_*`` method in
  ``kernel_shap.py``) missing.
* ``DKS-L002`` — consts builder missing, or present but not keyed by
  ``content_fingerprint`` into the bounded device cache.  The port's
  builders store through one LRU helper (``_shared_consts``), so a builder
  passes when it either stores itself (the reference's test) or hands a
  fingerprint-keyed key to a same-class helper that stores into the cache
  with an LRU bound (``popitem``).
* ``DKS-L003`` — serving path-label wiring missing: the path's serve
  label must be a seed key of ``serving/wrappers._path_counts`` (the
  ``dks_serve_explain_path_total`` label site) and, for auto-selected
  paths, an ``explain_path = "<label>"`` assignment must exist.
* ``DKS-L004`` — fallback counter family literal
  (``dks_*_fallback_total``) not registered anywhere in the package.
* ``DKS-L005`` — warmup signature wiring broken: ``shape_signature``
  no longer spells the ``,path=`` component, or the server's warmup rung
  no longer passes the model's ``explain_path`` into it.
"""

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

from distributedkernelshap_tpu_torch.analysis.core import Finding

PKG = "distributedkernelshap_tpu_torch"

CLASSIFY = f"{PKG}/registry/classify.py"
ENGINE = f"{PKG}/kernel_shap.py"
WRAPPERS = f"{PKG}/serving/wrappers.py"
COMPILE_CACHE = f"{PKG}/runtime/compile_cache.py"
SERVER = f"{PKG}/serving/server.py"


@dataclass(frozen=True)
class RungSpec:
    dispatch: str                 # method name in kernel_shap.py
    consts: Optional[str]         # consts builder method (None = exempt)
    serve_label: str              # dks_serve_explain_path_total label
    fallback: Optional[str]       # fallback counter family (None = exempt)
    explicit_selection: bool      # label must be assigned to explain_path


#: audited rung specs for the shipped paths.  ``sampled`` IS the fallback
#: and keeps no consts cache; ``linear`` rides the sampled estimator
#: (its ladder artifact is the plan-constant cache) and shares its label.
RUNG_SPECS: Dict[str, RungSpec] = {
    "linear": RungSpec("_dispatch_array", "_plan_consts", "sampled",
                       None, False),
    "exact_tree": RungSpec("_dispatch_exact", "_exact_consts", "exact",
                           "dks_treeshap_fallback_total", True),
    "exact_tn": RungSpec("_dispatch_exact_tn", "_exact_tn_consts",
                         "exact_tn", "dks_tensor_shap_fallback_total",
                         True),
    "deepshap": RungSpec("_dispatch_deepshap", "_deepshap_consts",
                         "deepshap", "dks_deepshap_fallback_total", True),
    "sampled": RungSpec("_dispatch_array", None, "sampled", None, False),
    # anytime is not a classifier path (requests classify as `sampled`;
    # refinement is a SERVING mode over that estimator), but its ladder
    # is real: a round dispatch entry, a schedule-fingerprint-keyed
    # consts cache and the shared sampled serve label.  Listing it here
    # keeps the rung checked even though ENGINE_PATHS never names it.
    "anytime": RungSpec("_dispatch_anytime_round", "_anytime_consts",
                        "sampled", None, False),
}


def _spec_for(path_name: str) -> RungSpec:
    return RUNG_SPECS.get(path_name, RungSpec(
        f"_dispatch_{path_name}", f"_{path_name}_consts", path_name,
        f"dks_{path_name}_fallback_total", True))


def _read(root: str, rel: str) -> Optional[str]:
    try:
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return None


def _parse(src: Optional[str]) -> Optional[ast.Module]:
    if src is None:
        return None
    try:
        return ast.parse(src)
    except SyntaxError:
        return None


def engine_paths(root: str) -> List[str]:
    """The ``ENGINE_PATHS`` tuple, read from the classifier's AST."""

    tree = _parse(_read(root, CLASSIFY))
    if tree is None:
        return []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and \
                        target.id == "ENGINE_PATHS":
                    try:
                        return [str(p) for p in
                                ast.literal_eval(node.value)]
                    except (ValueError, SyntaxError):
                        return []
    return []


def _methods(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _class_methods(tree: ast.Module) -> Dict[int, Dict[str, ast.FunctionDef]]:
    """``{id(method): {name: method}}`` of the class each method sits in."""

    out: Dict[int, Dict[str, ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            members = {m.name: m for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            for m in members.values():
                out[id(m)] = members
    return out


def _fingerprinted(text: str) -> bool:
    return "content_fingerprint" in text or "plan_fingerprint" in text


_DEVICE_CACHES = ("_plan_consts_cache", "_dev_cache")


def _stores_bounded(fn: ast.FunctionDef) -> bool:
    """``fn`` stores into one of the bounded device caches under the key it
    is given (its first parameter after ``self`` appears in the subscript
    of ``self.<cache>[...] = ...``) and evicts from that cache
    (``popitem``)."""

    params = [a.arg for a in fn.args.args]
    if len(params) < 2:
        return False
    key = params[1]
    stored, evicted = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Subscript) and \
                        isinstance(target.value, ast.Attribute) and \
                        target.value.attr in _DEVICE_CACHES and \
                        any(isinstance(n, ast.Name) and n.id == key
                            for n in ast.walk(target.slice)):
                    stored.add(target.value.attr)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "popitem" and \
                isinstance(node.func.value, ast.Attribute) and \
                node.func.value.attr in _DEVICE_CACHES:
            evicted.add(node.func.value.attr)
    return bool(stored & evicted)


def _fingerprint_keyed(fn: ast.FunctionDef,
                       siblings: Optional[Dict[str, ast.FunctionDef]] = None
                       ) -> bool:
    """The consts builder must key on the engine content fingerprint and
    store into one of the bounded device caches: itself, or through a
    ``self.<helper>(key, ...)`` call of its class whose key expression (or
    the local it names) carries the fingerprint and whose helper stores
    under that key with an LRU bound."""

    src = ast.unparse(fn)
    if _fingerprinted(src) and \
            ("_plan_consts_cache" in src or "_dev_cache" in src):
        return True
    local: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            local[node.targets[0].id] = ast.unparse(node.value)
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and node.args
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"):
            continue
        helper = (siblings or {}).get(node.func.attr)
        if helper is None or helper is fn:
            continue
        key = node.args[0]
        text = local.get(key.id, "") if isinstance(key, ast.Name) \
            else ast.unparse(key)
        if _fingerprinted(text) and _stores_bounded(helper):
            return True
    return False


def _path_count_labels(tree: ast.Module) -> List[str]:
    """Keys of the module-level ``_path_counts`` seed dict in
    serving/wrappers.py — the ``dks_serve_explain_path_total`` label
    universe."""

    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        for target in targets:
            if isinstance(target, ast.Name) and \
                    target.id == "_path_counts" and \
                    isinstance(node.value, ast.Dict):
                return [k.value for k in node.value.keys
                        if isinstance(k, ast.Constant)]
    return []


def _explain_path_assignments(tree: ast.Module) -> List[str]:
    """Every string constant assigned to an ``explain_path`` attribute
    (directly or as the first element of a tuple assignment)."""

    values: List[str] = []

    def collect(target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Attribute) and \
                target.attr == "explain_path":
            if isinstance(value, ast.Constant) and \
                    isinstance(value.value, str):
                values.append(value.value)
            # `self.explain_path, reason = path, "pinned"` style: any
            # string constants inside the value expression count
            else:
                for n in ast.walk(value):
                    if isinstance(n, ast.Constant) and \
                            isinstance(n.value, str):
                        values.append(n.value)

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Tuple):
                    for i, elt in enumerate(target.elts):
                        if isinstance(node.value, ast.Tuple) and \
                                i < len(node.value.elts):
                            collect(elt, node.value.elts[i])
                else:
                    collect(target, node.value)
    return values


def check_ladder(root: str, package_sources: Dict[str, str]
                 ) -> List[Finding]:
    """All ladder findings.  ``package_sources`` maps repo-relative path
    -> source text for every package module (the fallback-counter scan
    needs the whole package)."""

    findings: List[Finding] = []
    paths = engine_paths(root)
    if not paths:
        findings.append(Finding(
            "DKS-L003", CLASSIFY, 1, "ENGINE_PATHS",
            "registry/classify.ENGINE_PATHS missing or unparseable — "
            "the ladder contract has no path universe to check",
            "restore the ENGINE_PATHS tuple literal"))
        return findings
    engine_tree = _parse(_read(root, ENGINE))
    wrappers_tree = _parse(_read(root, WRAPPERS))
    engine_methods = _methods(engine_tree) if engine_tree else {}
    classes = _class_methods(engine_tree) if engine_tree else {}
    labels = _path_count_labels(wrappers_tree) if wrappers_tree else []
    selections = _explain_path_assignments(wrappers_tree) \
        if wrappers_tree else []
    # the fallback-family scan must not see the analysis package itself:
    # RUNG_SPECS quotes the very literals being checked for, so including
    # analysis/ would satisfy DKS-L004 even after the real registration
    # (ops/treeshap.py etc.) is deleted
    all_sources = "\n".join(
        src for rel, src in package_sources.items()
        if not rel.startswith(f"{PKG}/analysis/"))
    # audited specs outside the classifier's universe (serving modes
    # like `anytime` that refine an existing path) get the same rung
    # checks: their dispatch/consts artifacts are just as easy to lose.
    # Each is mandatory only while its subsystem package ships in the
    # scanned tree — reduced-universe trees (the test fixtures) stay
    # judged by their own ENGINE_PATHS
    extra = [name for name in RUNG_SPECS
             if name not in paths
             and any(rel.startswith(f"{PKG}/{name}/")
                     for rel in package_sources)]
    for path_name in paths + extra:
        spec = _spec_for(path_name)
        sym = f"path:{path_name}"
        dispatch = engine_methods.get(spec.dispatch)
        if dispatch is None:
            findings.append(Finding(
                "DKS-L001", ENGINE, 1, sym,
                f"engine dispatch entry `{spec.dispatch}` for path "
                f"'{path_name}' is missing from kernel_shap.py",
                f"implement `{spec.dispatch}` mirroring the existing "
                f"`_dispatch_exact` contract (StagedRows handling, "
                f"donated entry, finalize)"))
        if spec.consts is not None:
            consts = engine_methods.get(spec.consts)
            if consts is None:
                findings.append(Finding(
                    "DKS-L002", ENGINE, 1, sym,
                    f"X-independent consts builder `{spec.consts}` for "
                    f"path '{path_name}' is missing",
                    "build the path's device constants once and serve "
                    "them from the content-fingerprint LRU cache"))
            elif not _fingerprint_keyed(consts, classes.get(id(consts))):
                findings.append(Finding(
                    "DKS-L002", ENGINE, consts.lineno, sym,
                    f"consts builder `{spec.consts}` is not keyed by the "
                    f"engine content fingerprint into the bounded device "
                    f"cache — cache hits can serve a refitted engine's "
                    f"stale constants",
                    "key by `self.content_fingerprint()` and store in "
                    "`self._plan_consts_cache` (LRU-bounded), e.g. through "
                    "`self._shared_consts(key, build)`"))
        if spec.serve_label not in labels:
            findings.append(Finding(
                "DKS-L003", WRAPPERS, 1, sym,
                f"serve label '{spec.serve_label}' for path "
                f"'{path_name}' is not seeded in "
                f"serving/wrappers._path_counts — the "
                f"dks_serve_explain_path_total family will not carry "
                f"the path",
                "seed the label in _path_counts and record it via "
                "record_explain_path"))
        if spec.explicit_selection and spec.serve_label not in selections:
            findings.append(Finding(
                "DKS-L003", WRAPPERS, 1, sym,
                f"no `explain_path = '{spec.serve_label}'` assignment "
                f"in serving/wrappers.py — requests can never be "
                f"attributed to path '{path_name}' (and its warmup "
                f"rungs compile under the wrong signature)",
                "wire the path into _resolve_explain_path's "
                "auto-selection"))
        if spec.fallback is not None and \
                f'"{spec.fallback}"' not in all_sources and \
                f"'{spec.fallback}'" not in all_sources:
            findings.append(Finding(
                "DKS-L004", ENGINE, 1, sym,
                f"fallback counter family `{spec.fallback}` for path "
                f"'{path_name}' is not registered anywhere in the "
                f"package — readiness-gate fallbacks would be invisible",
                "register the counter next to the path's readiness gate "
                "(mirror ops/treeshap.record_exact_fallback)"))
    findings.extend(_check_warmup_wiring(root))
    return findings


_WARM_SIG_RE = re.compile(r"shape_signature\([^)]*explain_path", re.S)


def _check_warmup_wiring(root: str) -> List[Finding]:
    findings = []
    cc_src = _read(root, COMPILE_CACHE) or ""
    if ",path=" not in cc_src:
        findings.append(Finding(
            "DKS-L005", COMPILE_CACHE, 1, "shape_signature",
            "compile_cache.shape_signature no longer spells the "
            "`,path=<p>` signature component — warmup rungs for "
            "distinct paths collapse onto one label",
            "restore the `path` component of the declared compile "
            "signature"))
    server_src = _read(root, SERVER) or ""
    if not _WARM_SIG_RE.search(server_src):
        findings.append(Finding(
            "DKS-L005", SERVER, 1, "_warm_rung",
            "the warmup rung no longer passes the model's "
            "`explain_path` into shape_signature — per-path rungs "
            "become unattributable and the compile-accounting gate "
            "goes blind",
            "pass `getattr(model, 'explain_path', None)` into "
            "shape_signature in _warm_rung"))
    return findings
