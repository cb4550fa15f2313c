"""Observability drift lint of the PyTorch port (the port's counterpart of
``scripts/obs_check.py``).

New metrics must not drift undocumented and must not bypass the central
registry.  Four checks, exit 1 on any failure:

1. **Catalog diff** -- the port's live registries' self-description (every
   ``dks_*`` series its ``ExplainerServer``, ``FanInProxy`` and
   ``Autoscaler`` register) must match the metric catalog table in
   ``docs/OBSERVABILITY.md`` exactly: same names, same types, same label
   sets, both directions.  The port serves the reference's catalog.
2. **Literal scan** -- every metric-shaped string literal in the port's
   sources (the package, ``chip_smoke.py``, ``scripts/torch_*.py``,
   ``tests/test_torch_*.py``) must name a registered metric.
3. **Renderer scan** -- no Prometheus exposition rendering (the HELP /
   TYPE comment markers) in those sources outside a path naming
   ``observability``: the registry is the one renderer.
4. **Label-cardinality lint** -- every registered metric with a ``model``
   label declares a cardinality cap or a retire hook.

The components are built on the card when one is visible, else on the
CPU: the catalog is the registry's, the device only decides where the stub
engine sits.

    python scripts/torch_observability_check.py [--print-catalog]
"""

import argparse
import glob
import os
import re
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

DOCS_PATH = os.path.join(REPO_ROOT, "docs", "OBSERVABILITY.md")
PACKAGE_DIR = "distributedkernelshap_tpu_torch"

#: metric-shaped literals, the prefixes of ``scripts/obs_check.py``
_LITERAL_RE = re.compile(
    r"dks_(?:serve|fanin|sched|phase|slo|alerts|wire|staging|treeshap|"
    r"tensor_shap|autoscale|registry|result_cache|deepshap|device|tenant|"
    r"fleet|trace|anytime|prof|mem|quality|pod)_[a-z0-9_]+")
#: the exposition markers, spelled so that this file carries neither
_RENDER_MARKERS = tuple("# " + word for word in ("HELP", "TYPE"))


def default_device() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def live_catalog(device):
    """Instantiate the port's real components on ``device`` and collect
    their registries' self-description -- the ground truth the docs are
    diffed against."""

    import torch
    from distributedkernelshap_tpu_torch.serving.autoscaler import Autoscaler
    from distributedkernelshap_tpu_torch.serving.replicas import FanInProxy
    from distributedkernelshap_tpu_torch.serving.server import ExplainerServer
    from distributedkernelshap_tpu_torch.utils import resolve_device

    class _StubEngine:
        """An engine the server can place (``serving_device``) without a
        fitted model: registration happens in ``__init__``."""

        predictor = None

        def __init__(self, dev):
            self.device = dev

    stub = _StubEngine(resolve_device(torch.device(device)))
    # cache enabled so the conditional cache series register; nothing is
    # start()ed.  The autoscaler registers its series on the proxy's
    # registry (fleet=None: metrics-only construction, no control loop).
    server = ExplainerServer(stub, cache_bytes=1024)
    proxy = FanInProxy([("127.0.0.1", 1)])
    Autoscaler(None, proxy)
    described = server.metrics.describe() + proxy.metrics.describe()
    return {d["name"]: d for d in described}


def docs_catalog():
    """The metric catalog table of docs/OBSERVABILITY.md: ``| name | type |
    labels | help |`` rows."""

    if not os.path.exists(DOCS_PATH):
        return None
    catalog = {}
    with open(DOCS_PATH, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line.startswith("| `dks_"):
                continue
            cells = [c.strip() for c in line.strip("|").split("|")]
            if len(cells) < 3:
                continue
            name = cells[0].strip("`")
            labels = [] if cells[2] in ("", "—", "-") else \
                [c.strip().strip("`") for c in cells[2].split(",")]
            catalog[name] = {"name": name, "type": cells[1],
                             "labels": labels}
    return catalog


def port_sources():
    """Repo-relative paths of the port's Python sources."""

    paths = []
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(REPO_ROOT, PACKAGE_DIR)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        paths += [os.path.join(dirpath, n) for n in sorted(filenames)
                  if n.endswith(".py")]
    paths.append(os.path.join(REPO_ROOT, "chip_smoke.py"))
    paths += sorted(glob.glob(os.path.join(REPO_ROOT, "scripts", "torch_*.py")))
    paths += sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "test_torch_*.py")))
    return [os.path.relpath(p, REPO_ROOT).replace(os.sep, "/")
            for p in paths if os.path.exists(p)]


def sample_names(catalog):
    """Registered series names plus the derived histogram sample names."""

    names = set(catalog)
    for name, d in catalog.items():
        if d["type"] == "histogram":
            names.update({name + s for s in ("_bucket", "_sum", "_count")})
    return names


def check(device=None, verbose=True):
    problems = []
    live = live_catalog(device or default_device())

    docs = docs_catalog()
    if docs is None:
        problems.append(f"missing {DOCS_PATH}")
    else:
        for name, d in sorted(live.items()):
            doc = docs.get(name)
            if doc is None:
                problems.append(f"undocumented metric: {name} "
                                f"(add it to docs/OBSERVABILITY.md)")
            elif doc["type"] != d["type"]:
                problems.append(f"{name}: docs say type {doc['type']}, "
                                f"registry says {d['type']}")
            elif doc["labels"] != list(d["labels"]):
                problems.append(f"{name}: docs say labels {doc['labels']}, "
                                f"registry says {list(d['labels'])}")
        for name in sorted(set(docs) - set(live)):
            problems.append(f"documented but not registered: {name} "
                            f"(stale docs/OBSERVABILITY.md row?)")

    for name, d in sorted(live.items()):
        if "model" in d.get("labels", []) and not d.get("cardinality"):
            problems.append(
                f"{name}: model-labeled metric declares neither a "
                f"cardinality cap (bound_cardinality) nor a retire hook "
                f"(declare_retirement) -- a tenant flood or churn would "
                f"grow its label space without bound")

    legal = sample_names(live)
    for rel in port_sources():
        with open(os.path.join(REPO_ROOT, rel), encoding="utf-8",
                  errors="replace") as fh:
            source = fh.read()
        for m in sorted(set(_LITERAL_RE.findall(source))):
            if m not in legal:
                problems.append(f"{rel}: dks_ literal {m!r} is not a "
                                f"registered metric (emit it through the "
                                f"observability registry)")
        if "observability" not in rel and \
                any(marker in source for marker in _RENDER_MARKERS):
            problems.append(f"{rel}: hand-rolled exposition rendering "
                            f"(HELP/TYPE marker literal) outside the "
                            f"registry")
    if verbose:
        for p in problems:
            print(f"obs-check: {p}")
        print(f"obs-check: {len(live)} registered metrics, "
              f"{len(problems)} problem(s)")
    return problems


def print_catalog():
    live = live_catalog(default_device())
    print("| metric | type | labels | description |")
    print("| --- | --- | --- | --- |")
    for name, d in sorted(live.items()):
        labels = ", ".join(f"`{ln}`" for ln in d["labels"]) or "—"
        print(f"| `{name}` | {d['type']} | {labels} | {d['help']} |")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--print-catalog", action="store_true",
                        help="emit the docs markdown table and exit")
    args = parser.parse_args()
    if args.print_catalog:
        print_catalog()
        return 0
    return 1 if check() else 0


if __name__ == "__main__":
    sys.exit(main())
