"""The port's static analysis and lock witness
(``distributedkernelshap_tpu_torch/analysis/``), held against the JAX
package's: the concurrency family gives the reference's findings on its
fixtures, the torch-contract ids fire on their bad fixtures and stay silent
on the good twins, the serving ladder follows the port's ``_shared_consts``
helper without losing a rung deletion, the suppression contract, the
repo-wide gate (``scripts/torch_lint.py``) with its observability check and
health replay against the reference scripts, and the runtime witness."""

import ast
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from distributedkernelshap_tpu.analysis import concurrency as jax_concurrency
from distributedkernelshap_tpu.analysis import ladder as jax_ladder
from distributedkernelshap_tpu.analysis.driver import \
    package_sources as jax_package_sources
from distributedkernelshap_tpu_torch.analysis import concurrency, ladder, \
    lockwitness, torch_contract
from distributedkernelshap_tpu_torch.analysis.core import (
    apply_suppressions,
    load_baseline,
    suppressed_lines,
)
from distributedkernelshap_tpu_torch.analysis.driver import (
    PACKAGE_DIR,
    lint_repo,
    package_sources,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import scripts.health_check as jax_health  # noqa: E402
import scripts.obs_check as jax_obs  # noqa: E402
import scripts.torch_health_check as torch_health  # noqa: E402
import scripts.torch_observability_check as torch_obs  # noqa: E402

JAX_FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "lint")
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "lint_torch")
JAX_LADDER_GOOD = os.path.join(JAX_FIXTURES, "ladder_good")
LADDER_GOOD = os.path.join(FIXTURES, "ladder_good")
PKG = PACKAGE_DIR
JAX_PKG = "distributedkernelshap_tpu"


def _parse(path):
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    return ast.parse(src, filename=path), \
        os.path.relpath(path, REPO_ROOT).replace(os.sep, "/")


def _keys(findings, check_id):
    return sorted((f.check_id, f.line, f.symbol) for f in findings
                  if f.check_id == check_id)


# --------------------------------------------------------------------- #
# concurrency: the reference's findings on the reference's fixtures
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("variant", ["bad", "good"])
@pytest.mark.parametrize("check_id", ["DKS-C001", "DKS-C002", "DKS-C003",
                                      "DKS-C004", "DKS-C005"])
def test_concurrency_gives_the_references_findings(check_id, variant):
    stem = check_id.replace("DKS-", "").lower()
    tree, rel = _parse(os.path.join(JAX_FIXTURES, f"{stem}_{variant}.py"))
    ours = _keys(concurrency.check_module(tree, rel), check_id)
    theirs = _keys(jax_concurrency.check_module(tree, rel), check_id)
    assert ours == theirs
    if variant == "bad":
        assert ours, f"{check_id} did not fire on its known-bad fixture"
    else:
        assert ours == [], f"{check_id} false-positives on its good twin"


# --------------------------------------------------------------------- #
# torch contract: J001-J003 on their twins
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("variant", ["bad", "good"])
@pytest.mark.parametrize("check_id", ["DKS-J001", "DKS-J002", "DKS-J003"])
def test_torch_contract_fixture(check_id, variant):
    stem = check_id.replace("DKS-", "").lower()
    tree, rel = _parse(os.path.join(FIXTURES, f"{stem}_{variant}.py"))
    hits = [f for f in torch_contract.check_module(tree, rel)
            if f.check_id == check_id]
    if variant == "good":
        assert hits == [], [f.render() for f in hits]
        return
    assert hits, f"{check_id} did not fire on its known-bad fixture"
    for f in hits:
        assert f.line > 0 and f.hint, "every finding carries a fix hint"
        assert check_id in f.render() and f"{f.file}:{f.line}" in f.render()


def test_j001_and_j002_report_each_write():
    """Each write of the bad fixtures is its own finding: the caller's
    tensor, ``out=`` into object state and a write through a view (J001);
    an entry read through ``_device_args``, an in-place write, an alias,
    ``out=`` into a cache and a kernel's output pointer (J002)."""

    tree, rel = _parse(os.path.join(FIXTURES, "j001_bad.py"))
    j001 = [f for f in torch_contract.check_module(tree, rel)]
    assert [(f.check_id, f.symbol) for f in j001] == [
        ("DKS-J001", "scale_rows"), ("DKS-J001", "add"), ("DKS-J001", "reset")]
    tree, rel = _parse(os.path.join(FIXTURES, "j002_bad.py"))
    j002 = torch_contract.check_module(tree, rel)
    assert [f.check_id for f in j002] == ["DKS-J002"] * 5
    assert "kernel launch" in j002[-1].message


def test_j003_reports_every_kind_of_host_work():
    tree, rel = _parse(os.path.join(FIXTURES, "j003_bad.py"))
    hits = torch_contract.check_module(tree, rel)
    messages = " ".join(f.message for f in hits)
    for kind in ("np.random.normal", "time.perf_counter", "random.random",
                 "float(<tensor>)", ".item()", ".cpu()", ".numpy()"):
        assert kind in messages, kind
    # the helper the closure reaches by name is checked too
    assert {f.symbol for f in hits} == {"fn", "_host_norm"}


def test_allowlist_silences_j001_but_never_a_cache_write():
    src = ("def init(net):\n"
           "    net.weight.zero_()\n"
           "    net._plan_consts_cache['k'].zero_()\n")
    tree = ast.parse(src)
    raw = torch_contract.check_inplace(tree, "p/m.py", allowlist=set())
    assert [(f.check_id, f.line) for f in raw] == [("DKS-J001", 2),
                                                   ("DKS-J002", 3)]
    audited = torch_contract.check_inplace(tree, "p/m.py",
                                           allowlist={("p/m.py", "init")})
    assert [(f.check_id, f.line) for f in audited] == [("DKS-J002", 3)]


def test_every_audited_site_and_device_entry_exists_in_the_port():
    """An allowlist or device-entry row naming a function that is gone
    would let J001 or J003 go blind without a sound; and the device roots
    must cover the builders' closures of each engine path."""

    sources = package_sources(REPO_ROOT)
    defined = {}
    for rel, src in sources.items():
        defined[rel] = {n.name for n in ast.walk(ast.parse(src))
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
    for rel, name in torch_contract.INPLACE_ALLOWLIST | \
            torch_contract.DEVICE_ENTRIES:
        assert name in defined.get(rel, ()), (rel, name)
    roots = {}
    for rel, src in sources.items():
        names = [fn.name for fn in
                 torch_contract._device_roots(ast.parse(src), rel)]
        if names:
            roots[rel] = names
    assert "explain" in roots[f"{PKG}/ops/explain.py"]
    assert {"round0", "round_k"} <= set(roots[f"{PKG}/anytime/engine.py"])
    assert roots[f"{PKG}/attribution/deepshap.py"]
    assert roots[f"{PKG}/parallel/coalition_sharding.py"]


def test_j003_keeps_host_plan_code_and_the_fetch_outside():
    """The one device-to-host copy (``fetch_transfer``), the host plan
    builder and the seeded host RNG of the anytime draws are host code the
    device functions do not reach: J003 is silent on their modules although
    each holds host work."""

    for rel, marker in ((f"{PKG}/ops/explain.py", "packed.cpu().numpy()"),
                        (f"{PKG}/ops/treeshap.py", ".cpu().numpy()"),
                        (f"{PKG}/anytime/rounds.py", "np.random.default_rng")):
        with open(os.path.join(REPO_ROOT, rel), encoding="utf-8") as fh:
            src = fh.read()
        assert marker in src, (rel, marker)
        hits = torch_contract.check_device_purity(ast.parse(src), rel)
        assert hits == [], [f.render() for f in hits]


# --------------------------------------------------------------------- #
# suppression: pragmas, the baseline and its drift
# --------------------------------------------------------------------- #


def test_pragma_covers_own_line_and_line_below():
    src = ("x = 1  # dks: allow(DKS-J001)\n"
           "\n"
           "# dks: allow(DKS-J002, DKS-C004): deliberate, reviewed\n"
           "y = 2\n")
    allowed = suppressed_lines(src)
    assert allowed[1] == {"DKS-J001"} and allowed[2] == {"DKS-J001"}
    assert allowed[3] == allowed[4] == {"DKS-J002", "DKS-C004"}
    assert 5 not in allowed


def test_pragma_suppresses_only_the_named_id():
    with open(os.path.join(FIXTURES, "j001_bad.py"), encoding="utf-8") as fh:
        src = fh.read()
    line = "x.mul_(w[:, None])"
    assert line in src
    for pragma, expect_active in (("DKS-J002", 3), ("DKS-J001", 2)):
        variant = src.replace(line, f"{line}  # dks: allow({pragma})")
        raw = torch_contract.check_module(ast.parse(variant), "p/m.py")
        active, suppressed, stale = apply_suppressions(
            raw, {"p/m.py": variant}, [])
        assert len(active) == expect_active
        assert len(suppressed) == 3 - expect_active and stale == []


def _lint_tree(tmp_path, extra_module=None, baseline_text=None):
    """The port-shaped ladder_good tree (rung-complete, so the ladder is
    quiet) plus an optional extra module and baseline, through the real
    ``lint_repo``."""

    root = tmp_path / "tree"
    if not root.exists():
        shutil.copytree(LADDER_GOOD, root)
    if extra_module is not None:
        (root / PKG / "mod.py").write_text(extra_module)
    if baseline_text is not None:
        adir = root / PKG / "analysis"
        adir.mkdir(exist_ok=True)
        (adir / "baseline.toml").write_text(baseline_text)
    return lint_repo(str(root))


def test_ladder_good_tree_is_clean(tmp_path):
    result = _lint_tree(tmp_path)
    assert result.ok, [f.render() for f in result.active]
    assert result.files_scanned == 6


def test_new_finding_fails_and_baseline_suppresses(tmp_path):
    with open(os.path.join(FIXTURES, "j002_bad.py"), encoding="utf-8") as fh:
        bad_src = fh.read()
    result = _lint_tree(tmp_path, extra_module=bad_src)
    assert not result.ok
    assert {f.check_id for f in result.active} == {"DKS-J002"}
    f = result.active[0]
    entry = ('[[finding]]\n'
             f'id = "{f.check_id}"\n'
             f'file = "{f.file}"\n')
    # symbol-scoped: only the `explain` findings are accepted
    result = _lint_tree(tmp_path, extra_module=bad_src, baseline_text=(
        entry + 'symbol = "explain"\njustification = "tracked"\n'))
    assert [g.symbol for g in result.active] == ["launch"]
    # an empty symbol matches every symbol in the file
    result = _lint_tree(tmp_path, extra_module=bad_src, baseline_text=entry)
    assert result.ok and len(result.suppressed) == 5


def test_stale_baseline_entry_fails_the_lint(tmp_path):
    result = _lint_tree(tmp_path, baseline_text=(
        '[[finding]]\n'
        'id = "DKS-J001"\n'
        f'file = "{PKG}/mod.py"\n'
        'symbol = "scale_rows"\n'
        'justification = "the debt was paid; this entry is now stale"\n'))
    assert not result.ok
    assert [(e.id, e.symbol) for e in result.stale_baseline] == [
        ("DKS-J001", "scale_rows")]


@pytest.mark.parametrize("text,match", [
    ('[[finding]]\nid = "DKS-J001"\nfile = unquoted\n', "unparseable"),
    ('id = "DKS-J001"\n', "outside"),
    ('[[finding]]\nid = "DKS-J001"\nfile = "f.py"\nseverity = "high"\n',
     "unknown baseline key"),
    ('[[finding]]\nid = "DKS-J001"\n', "missing id/file"),
])
def test_malformed_baseline_raises(tmp_path, text, match):
    p = tmp_path / "baseline.toml"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        load_baseline(str(p))
    assert load_baseline(str(tmp_path / "missing.toml")) == []


def test_the_ports_baseline_is_empty():
    """Every finding on the port was fixed in code or carries a pragma at
    its site: the committed baseline accepts nothing (so the repaired
    ``kernel_path`` race cannot be hiding in it)."""

    assert load_baseline(os.path.join(REPO_ROOT, PKG, "analysis",
                                      "baseline.toml")) == []


# --------------------------------------------------------------------- #
# serving ladder: the same ids as the reference on the same deletions
# --------------------------------------------------------------------- #


def _mutated(tmp_path, src_root, pkg, rel, old, new):
    root = tmp_path / os.path.basename(os.path.dirname(src_root))
    shutil.copytree(src_root, root)
    target = root / pkg / rel
    text = target.read_text()
    assert old in text, f"mutation anchor {old!r} missing from {rel}"
    target.write_text(text.replace(old, new))
    return root


def _port_ladder(root):
    return ladder.check_ladder(str(root), package_sources(str(root)))


def _jax_ladder(root):
    return jax_ladder.check_ladder(str(root), jax_package_sources(str(root)))


#: (deleted artifact, expected id, rel path, the reference tree's mutation,
#: the port-shaped tree's mutation): the reference's RUNG_DELETIONS
#: (tests/test_static_analysis.py) on both trees
RUNG_DELETIONS = [
    ("dispatch entry", "DKS-L001", "kernel_shap.py",
     ("def _dispatch_exact(", "def _dispatch_exact_gone("),
     ("def _dispatch_exact(", "def _dispatch_exact_gone(")),
    ("consts builder", "DKS-L002", "kernel_shap.py",
     ("def _exact_consts(", "def _exact_consts_gone("),
     ("def _exact_consts(", "def _exact_consts_gone(")),
    ("consts fingerprint key", "DKS-L002", "kernel_shap.py",
     ('key = ("exact_consts", self.content_fingerprint())',
      'key = ("exact_consts",)'),
     ('self._shared_consts(("exact_consts", self.content_fingerprint()),',
      'self._shared_consts(("exact_consts",),')),
    ("serve label seed", "DKS-L003", "serving/wrappers.py",
     ('"exact": 0.0, ', ""), ('"exact": 0.0, ', "")),
    ("explain_path selection", "DKS-L003", "serving/wrappers.py",
     ('self.explain_path = "exact"', "pass"),
     ('self.explain_path = "exact"', "pass")),
    ("fallback counter family", "DKS-L004", "ops/treeshap.py",
     ('"dks_treeshap_fallback_total"', '"no_longer_registered_anywhere"'),
     ('"dks_treeshap_fallback_total"', '"no_longer_registered_anywhere"')),
    ("warmup path= literal", "DKS-L005", "runtime/compile_cache.py",
     (",path=", ",p="), (",path=", ",p=")),
    ("warmup explain_path pass-through", "DKS-L005", "serving/server.py",
     ('getattr(model, "explain_path", None)', "None"),
     ('getattr(model, "explain_path", None)', "None")),
    ("linear key via a local", "DKS-L002", "kernel_shap.py",
     ("key = (self.content_fingerprint(), chunk)",
      "key = (chunk,)"),
     ("key = (self.content_fingerprint(), chunk)", "key = (chunk,)")),
]


@pytest.mark.parametrize(
    "artifact,check_id,rel,jax_mut,port_mut", RUNG_DELETIONS,
    ids=[r[0].replace(" ", "-") for r in RUNG_DELETIONS])
def test_deleting_a_rung_gives_the_references_id(tmp_path, artifact,
                                                  check_id, rel, jax_mut,
                                                  port_mut):
    ours = _port_ladder(_mutated(tmp_path / "port", LADDER_GOOD, PKG, rel,
                                 *port_mut))
    theirs = _jax_ladder(_mutated(tmp_path / "jax", JAX_LADDER_GOOD,
                                  JAX_PKG, rel, *jax_mut))
    assert check_id in {f.check_id for f in ours}, \
        f"deleting the {artifact} did not raise {check_id}"
    assert sorted((f.check_id, f.symbol) for f in ours) == \
        sorted((f.check_id, f.symbol) for f in theirs)


@pytest.mark.parametrize("old,new", [
    ("self._plan_consts_cache.popitem(last=False)", "break"),
    ("self._plan_consts_cache[key] = consts",
     'self._plan_consts_cache["consts"] = consts'),
], ids=["no-lru-bound", "constant-key"])
def test_a_shared_helper_without_an_lru_bound_keys_nothing(tmp_path, old,
                                                            new):
    """The helper must store under the key it is given and bound the cache
    (``popitem``): one that only stores, or stores under a constant that
    drops the fingerprint, fails every builder that goes through it."""

    root = _mutated(tmp_path, LADDER_GOOD, PKG, "kernel_shap.py", old, new)
    hits = [f for f in _port_ladder(root) if f.check_id == "DKS-L002"]
    assert {f.symbol for f in hits} == {"path:linear", "path:exact_tree"}


def test_the_reference_rule_alone_would_flag_the_ports_four_builders():
    """On the real engine the reference's textual rule (both names in the
    builder's own body) rejects the four builders that store through
    ``_shared_consts``; following the helper one call deep accepts them."""

    with open(os.path.join(REPO_ROOT, ladder.ENGINE), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    methods = ladder._methods(tree)
    classes = ladder._class_methods(tree)
    names = ("_plan_consts", "_exact_consts", "_exact_tn_consts",
             "_deepshap_consts")
    assert [jax_ladder._fingerprint_keyed(methods[n]) for n in names] == \
        [False] * 4
    assert [ladder._fingerprint_keyed(methods[n], classes[id(methods[n])])
            for n in names] == [True] * 4


def test_new_engine_path_fails_until_fully_wired(tmp_path):
    old = '("linear", "exact_tree", "sampled")'
    new = '("linear", "exact_tree", "sampled", "quadratic")'
    ours = _port_ladder(_mutated(tmp_path / "port", LADDER_GOOD, PKG,
                                 "registry/classify.py", old, new))
    theirs = _jax_ladder(_mutated(tmp_path / "jax", JAX_LADDER_GOOD, JAX_PKG,
                                  "registry/classify.py", old, new))
    got = {f.check_id for f in ours if f.symbol == "path:quadratic"}
    assert got == {"DKS-L001", "DKS-L002", "DKS-L003", "DKS-L004"}
    assert got == {f.check_id for f in theirs if f.symbol == "path:quadratic"}


def test_missing_engine_paths_is_itself_a_finding(tmp_path):
    hits = _port_ladder(_mutated(tmp_path, LADDER_GOOD, PKG,
                                 "registry/classify.py", "ENGINE_PATHS",
                                 "OTHER_PATHS"))
    assert [f.check_id for f in hits] == ["DKS-L003"]
    assert "no path universe" in hits[0].message


def test_real_tree_rung_deletion_fails(tmp_path):
    """The drill on the port's real artifacts: the copied files lint clean
    (the anytime rung included), then stripping the warmup ``path=``
    signature literal raises DKS-L005."""

    root = tmp_path / "repo"
    for rel in (ladder.CLASSIFY, ladder.ENGINE, ladder.WRAPPERS,
                ladder.COMPILE_CACHE, ladder.SERVER):
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(REPO_ROOT, rel), dst)
    real_sources = package_sources(REPO_ROOT)
    assert any(rel.startswith(f"{PKG}/anytime/") for rel in real_sources)
    assert ladder.check_ladder(str(root), real_sources) == []
    cc = root / ladder.COMPILE_CACHE
    cc.write_text(cc.read_text().replace(",path=", ",p="))
    hits = ladder.check_ladder(str(root), real_sources)
    assert any(f.check_id == "DKS-L005" and f.file == ladder.COMPILE_CACHE
               for f in hits)


# --------------------------------------------------------------------- #
# the repo-wide gate
# --------------------------------------------------------------------- #


def test_port_lint_is_green_inside_budget():
    result = lint_repo(REPO_ROOT)
    assert result.ok, [f.render() for f in result.active] + \
        [str(e) for e in result.stale_baseline] + result.parse_errors
    assert result.files_scanned == len(package_sources(REPO_ROOT))
    assert result.elapsed_s < 60.0


def test_torch_lint_cli_exits_0_without_jax():
    """One ``--check`` run: its report carries the static pass's keys as
    well as those of the observability check and the health replay."""

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts", "torch_lint.py"),
         "--check"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=180,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] is True and report["foreign_modules"] == []
    assert report["findings"] == report["stale_baseline"] == \
        report["parse_errors"] == 0
    assert report["files_scanned"] == len(package_sources(REPO_ROOT))
    assert report["obs_check_problems"] == 0
    assert report["obs_check_device"] == "cpu"
    assert report["health_check_ok"] is True
    assert report["static_elapsed_s"] < report["static_budget_s"]


def _triples(catalog):
    return {(n, d["type"], tuple(d["labels"])) for n, d in catalog.items()}


def test_port_live_catalog_equals_the_references_and_the_docs():
    ours = torch_obs.live_catalog("cpu")
    assert _triples(ours) == _triples(jax_obs.live_catalog())
    docs = torch_obs.docs_catalog()
    assert _triples(ours) == _triples(docs)
    assert torch_obs.check("cpu", verbose=False) == []


def test_port_observability_check_flags_drift(tmp_path, monkeypatch):
    """A stray metric-shaped literal, a renderer marker outside the
    registry and an undocumented row each fail the check."""

    (tmp_path / "docs").mkdir()
    with open(torch_obs.DOCS_PATH, encoding="utf-8") as fh:
        rows = fh.read()
    stray = "dks_" + "serve_bogus_total"
    (tmp_path / "docs" / "OBSERVABILITY.md").write_text(
        rows + f"| `{stray}` | counter | — | not registered |\n")
    (tmp_path / "scripts").mkdir()
    (tmp_path / "scripts" / "torch_stray.py").write_text(
        f"NAME = {stray!r}\nPAGE = {'# ' + 'HELP'!r}\n")
    monkeypatch.setattr(torch_obs, "REPO_ROOT", str(tmp_path))
    monkeypatch.setattr(torch_obs, "DOCS_PATH",
                        str(tmp_path / "docs" / "OBSERVABILITY.md"))
    problems = torch_obs.check("cpu", verbose=False)
    assert len(problems) == 3, problems
    assert any("documented but not registered" in p for p in problems)
    assert any("is not a registered metric" in p for p in problems)
    assert any("hand-rolled exposition" in p for p in problems)


def test_port_health_replay_gives_the_references_transitions(tmp_path):
    ours, theirs = torch_health.run_check(), jax_health.run_check()
    assert ours["ok"] and theirs["ok"]
    assert ours["transitions"] == theirs["transitions"]
    assert ours["final_state"] == theirs["final_state"]
    # a replay with no error burst never pends: the golden match fails
    from distributedkernelshap_tpu_torch.observability.timeseries import \
        TimeSeriesStore

    store = TimeSeriesStore(capacity=4096)
    for t in range(121):
        store.add("dks_serve_requests_total", float(t), 10.0 * t,
                  kind="counter")
        store.add("dks_serve_errors_total", float(t), 0.0, kind="counter")
    quiet = str(tmp_path / "quiet.jsonl")
    store.export_jsonl(quiet)
    report = torch_health.run_check(quiet)
    assert not report["ok"] and report["transitions"] == []


# --------------------------------------------------------------------- #
# the runtime lock witness (the cases of tests/test_lockwitness.py)
# --------------------------------------------------------------------- #


@pytest.fixture()
def witness(monkeypatch):
    """Witness on with clean process-wide state, reset afterwards."""

    monkeypatch.setenv(lockwitness.ENV_KNOB, "1")
    lockwitness.reset()
    yield lockwitness
    lockwitness.reset()


def test_witness_disabled_by_default_returns_plain_primitives(monkeypatch):
    monkeypatch.delenv(lockwitness.ENV_KNOB, raising=False)
    assert not lockwitness.enabled()
    lock = lockwitness.make_lock("plain")
    assert not isinstance(lock, lockwitness.WitnessedLock)
    cond = lockwitness.make_condition("plain.cond")
    assert isinstance(cond, threading.Condition)
    assert not isinstance(cond._lock, lockwitness.WitnessedLock)
    for off in ("0", "false", "off"):
        monkeypatch.setenv(lockwitness.ENV_KNOB, off)
        assert not lockwitness.enabled()


def test_witness_consistent_order_records_edges(witness):
    a, b = witness.make_lock("t.a"), witness.make_lock("t.b")
    assert isinstance(a, witness.WitnessedLock)
    for _ in range(3):
        with a:
            with b:
                pass
    snap = witness.assert_clean()
    assert snap["edges"] == {("t.a", "t.b"): 3}
    assert snap["acquisitions"] == {"t.a": 3, "t.b": 3}
    assert witness.problems() == []


@pytest.mark.parametrize("where", ["other thread", "same thread"])
def test_witness_order_inversion_is_a_cycle(witness, where):
    a, b = witness.make_lock("t.a"), witness.make_lock("t.b")
    with a:
        with b:
            pass

    def inverted():
        with b:
            with a:
                pass

    if where == "other thread":
        t = threading.Thread(target=inverted)
        t.start()
        t.join(5)
        assert not t.is_alive()
    else:
        inverted()
    issues = witness.problems()
    assert len(issues) == 1 and "cycle" in issues[0]
    assert "t.a" in issues[0] and "t.b" in issues[0]
    assert witness.find_cycle_in_edges(witness.snapshot()["edges"])
    with pytest.raises(AssertionError, match="cycle"):
        witness.assert_clean()


def test_witness_hold_time_budget(witness):
    a = witness.make_lock("slow.lock")
    with a:
        time.sleep(0.05)
    assert witness.problems(max_hold_s=1.0) == []
    issues = witness.problems(max_hold_s=0.01)
    assert len(issues) == 1 and "slow.lock" in issues[0]
    assert "must not bracket blocking work" in issues[0]


def test_witness_same_name_instances_never_fabricate_a_cycle(witness):
    a, b = witness.make_lock("model.cond"), witness.make_lock("model.cond")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    snap = witness.snapshot()
    assert snap["edges"] == {}
    assert snap["same_name_nestings"] == {"model.cond": 2}
    assert snap["acquisitions"]["model.cond"] == 4
    assert witness.problems() == []


def test_witness_rlock_nesting_is_not_an_edge(witness):
    r = witness.make_rlock("re.lock")
    with r:
        with r:
            pass
    snap = witness.snapshot()
    assert snap["acquisitions"]["re.lock"] == 2 and snap["edges"] == {}
    assert witness.problems() == []


def test_witness_condition_wait_releases_the_hold_clock(witness):
    cond = witness.make_condition("w.cond")
    with cond:
        cond.wait(0.3)
    snap = witness.snapshot()
    assert snap["acquisitions"]["w.cond"] == 2
    assert snap["max_hold_s"]["w.cond"] < 0.2
    assert witness.problems(max_hold_s=0.2) == []


def test_witness_reset_clears_state_and_overhead_is_metered(witness):
    a = witness.make_lock("o.a")
    for _ in range(100):
        with a:
            pass
    snap = witness.snapshot()
    assert snap["acquisitions"] == {"o.a": 100}
    assert 0.0 < snap["overhead_s"] < 0.5
    witness.reset()
    snap = witness.snapshot()
    assert snap["edges"] == {} and snap["acquisitions"] == {}
    assert snap["overhead_s"] == 0.0


def test_live_port_server_lock_graph_is_acyclic(witness):
    """A real port ``ExplainerServer`` on an explicit CPU device: start,
    health probe, metrics scrape, statusz, stop, with every named
    control-plane lock witnessed -- an acyclic graph inside the hold
    budget of ``tests/conftest.py``."""

    import torch
    from distributedkernelshap_tpu_torch.serving.server import ExplainerServer

    class _Stub:
        predictor = None
        device = torch.device("cpu")

    srv = ExplainerServer(_Stub(), host="127.0.0.1", port=0,
                          max_batch_size=1, health_interval_s=0,
                          warmup=False, pipeline_depth=1).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        for route in ("/healthz", "/metrics", "/statusz?format=json"):
            with urllib.request.urlopen(base + route, timeout=30) as resp:
                assert resp.status == 200
    finally:
        srv.stop()
    snap = lockwitness.assert_clean(max_hold_s=30.0)
    observed = set(snap["acquisitions"])
    assert any(name.startswith("server.") for name in observed)
    assert "scheduler.cond" in observed
