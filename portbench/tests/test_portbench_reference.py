"""The plain references against brute force, and against the port at small
sizes on the CPU."""

import ast
import itertools
import subprocess
import sys
from math import factorial
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.kinds.tree_ensemble import grow
from portbench.reference import coalitions, linear_softmax, treeshap

REFERENCE_DIR = Path(__file__).resolve().parent.parent / "reference"
ROOT = REFERENCE_DIR.parent.parent


def test_reference_imports_nothing_of_the_port():
    for path in REFERENCE_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in ("numpy", "torch", "math", "itertools",
                                              "portbench"), (path.name, name)
                if name.startswith("portbench"):
                    assert name.startswith("portbench.reference"), (path.name, name)
    code = ("import sys; import portbench.reference.coalitions, "
            "portbench.reference.linear_softmax, portbench.reference.treeshap; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'distributedkernelshap_tpu_torch', 'distributedkernelshap_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("M, seed", [(12, 0), (12, 2 ** 31 + 17), (5, 3), (20, 1), (48, 9)])
def test_plan_equals_the_ports(M, seed):
    from distributedkernelshap_tpu_torch.ops.coalitions import coalition_plan

    mask, weights = coalitions.plan(M, seed=seed)
    port = coalition_plan(M, seed=seed)
    assert np.array_equal(mask, port.mask) and np.array_equal(weights, port.weights)


def _brute_shapley(value, M):
    """Shapley values and pairwise interaction indices of ``value(S)``."""

    v = {S: value(S) for r in range(M + 1) for S in itertools.combinations(range(M), r)}
    phi = np.zeros(M)
    inter = np.zeros((M, M))
    for i in range(M):
        rest = [j for j in range(M) if j != i]
        for r in range(M):
            for S in itertools.combinations(rest, r):
                w = factorial(r) * factorial(M - r - 1) / factorial(M)
                phi[i] += w * (v[tuple(sorted(S + (i,)))] - v[S])
    for i, j in itertools.combinations(range(M), 2):
        rest = [k for k in range(M) if k not in (i, j)]
        for r in range(M - 1):
            for S in itertools.combinations(rest, r):
                w = factorial(r) * factorial(M - r - 2) / factorial(M - 1)
                d = (v[tuple(sorted(S + (i, j)))] - v[tuple(sorted(S + (i,)))]
                     - v[tuple(sorted(S + (j,)))] + v[S])
                inter[i, j] += w * d
                inter[j, i] += w * d
    return phi, inter


def _hybrid(x, z, S, groups):
    h = z.copy()
    for g in S:
        h[groups[g]] = x[groups[g]]
    return h


def test_treeshap_matches_brute_force():
    rng = np.random.default_rng(5)
    groups = [[0], [1, 2], [3], [4, 5]]
    sample = rng.normal(size=(200, 6)).astype(np.float32)
    tables = grow(rng, sample, n_trees=3, max_leaves=6, leaf_scale=1.0)
    X, bg = sample[:3], sample[50:54]
    phi, E, fx, inter = treeshap.explain(X, bg, np.ones(4), tables, groups, base=0.5)
    paths = treeshap.leaf_paths(tables)

    def f(row):
        out = 0.5
        for feat, thr, left, valid, val in zip(*paths[:4], paths[4]):
            if all((row[c] <= t) == lt for c, t, lt, ok in zip(feat, thr, left, valid) if ok):
                out += val
        return out

    for b in range(3):
        game = lambda S: np.mean([f(_hybrid(X[b], z, S, groups)) for z in bg])  # noqa: E731
        ref_phi, ref_inter = _brute_shapley(game, 4)
        assert np.allclose(phi[b], ref_phi, atol=1e-12)
        off = ref_inter / 2.0
        want = off + np.diag(ref_phi - off.sum(1))
        assert np.allclose(inter[b], want, atol=1e-12)
        assert fx[b] == pytest.approx(f(X[b]))
    assert E == pytest.approx(np.mean([f(z) for z in bg]))


def test_linear_reference_recovers_exact_shapley_values():
    # an exhaustive plan (2^M - 2 <= nsamples) makes the weighted least
    # squares exact: phi is the Shapley value of v(S) = logit E_n p(x_S, z_n)
    rng = np.random.default_rng(2)
    groups = [[0], [1, 2], [3]]
    G = np.zeros((3, 4))
    for g, cols in enumerate(groups):
        G[g, cols] = 1.0
    W, b = rng.normal(size=(4, 3)), rng.normal(size=3)
    X, bg = rng.normal(size=(2, 4)), rng.normal(size=(5, 4))
    mask, weights = coalitions.plan(3, nsamples=100)
    phi, E, fx = linear_softmax.explain(X, bg, np.ones(5), W, b, G, mask, weights, ridge=0.0)

    def prob(rows):
        z = rows @ W + b
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    for i in range(2):
        for k in range(3):
            def game(S, i=i, k=k):
                p = np.mean([prob(_hybrid(X[i], z, S, groups))[k] for z in bg])
                return np.log(p / (1 - p))
            ref_phi, _ = _brute_shapley(game, 3)
            assert np.allclose(phi[i, k], ref_phi, atol=1e-9)


def test_linear_reference_matches_the_port_on_the_cpu():
    from distributedkernelshap_tpu_torch import KernelShap

    from portbench.kinds.linear_softmax import SoftmaxRegression

    rng = np.random.default_rng(4)
    D, K, groups = 6, 4, [[0, 1], [2], [3, 4, 5]]
    G = np.zeros((3, D))
    for g, cols in enumerate(groups):
        G[g, cols] = 1.0
    coef = rng.normal(size=(K, D)).astype(np.float32).astype(np.float64)
    icpt = rng.normal(size=K).astype(np.float32).astype(np.float64)
    X = rng.normal(size=(16, D)).astype(np.float32)
    bg = rng.normal(size=(8, D)).astype(np.float32)
    ex = KernelShap(SoftmaxRegression(coef, icpt).predict_proba, link="logit", seed=3,
                    device="cpu").fit(bg, groups=groups, group_names=["a", "b", "c"])
    got = ex.explain(X, silent=True)
    mask, weights = coalitions.plan(3, seed=3)
    phi, E, fx = linear_softmax.explain(X, bg, np.ones(8), coef.T, icpt, G, mask, weights,
                                        dtype=torch.float64)
    assert np.abs(np.stack(got.shap_values, 1) - phi).max() < 1e-4
    assert np.abs(np.asarray(got.expected_value) - E).max() < 1e-5
