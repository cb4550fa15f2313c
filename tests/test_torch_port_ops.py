"""Parity of the PyTorch port's modules with the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through the JAX function and
its counterpart in ``distributedkernelshap_tpu_torch``.  Host-side numpy
artifacts (coalition plans) must be equal; device math agrees to f32
tolerances stated per test (the two frameworks sum in different orders).
The fused CUDA kernel cannot run here: its wrapper takes the plain PyTorch
version for CPU tensors, which is what these tests hold against the JAX
reference and against the Pallas kernel in interpret mode.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedkernelshap_tpu.models import predictors as jpred
from distributedkernelshap_tpu.ops import coalitions as jcoal
from distributedkernelshap_tpu.ops import explain as jexp
from distributedkernelshap_tpu.ops import links as jlinks
from distributedkernelshap_tpu.ops.pallas_kernels import fused_linear_ey as pallas_ey
from distributedkernelshap_tpu_torch.convert import linear_predictor_from_numpy
from distributedkernelshap_tpu_torch.models import predictors as tpred
from distributedkernelshap_tpu_torch.ops import coalitions as tcoal
from distributedkernelshap_tpu_torch.ops import cuda_kernels as tck
from distributedkernelshap_tpu_torch.ops import explain as texp
from distributedkernelshap_tpu_torch.ops import links as tlinks

CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# coalition plans: host numpy, must be bit-equal


@pytest.mark.parametrize("M,nsamples,seed", [
    (1, None, 0), (2, None, 0), (5, None, 3), (5, 10, 3), (8, None, 0),
    (8, 40, 1), (8, 41, 2), (12, None, 0), (12, None, 7), (12, 500, 5),
    (16, 300, 0), (30, 129, 4),
])
def test_coalition_plan_bit_equal(M, nsamples, seed):
    ref = jcoal.coalition_plan(M, nsamples=nsamples, seed=seed)
    got = tcoal.coalition_plan(M, nsamples=nsamples, seed=seed)
    assert np.array_equal(ref.mask, got.mask)
    assert np.array_equal(ref.weights, got.weights)
    assert (ref.exact, ref.n_enumerated) == (got.exact, got.n_enumerated)
    assert jcoal.plan_fingerprint(ref) == tcoal.plan_fingerprint(got)


def test_headline_plan_size():
    """The Adult headline plan: 2072 rows, l1 'auto' inactive (2072/4094 >= 0.2)."""

    plan = tcoal.coalition_plan(12, None, seed=0)
    assert plan.n_rows == 2072 and plan.n_rows / (2 ** 12 - 2) >= 0.2


# ---------------------------------------------------------------------------
# links


@pytest.mark.parametrize("link", ["identity", "logit"])
def test_links_match(link):
    rng = np.random.default_rng(0)
    p = rng.random(1000).astype(np.float32)
    p[:4] = [0.0, 1.0, 1e-9, 1.0 - 1e-9]       # the clip region
    ref = np.asarray(jlinks.convert_to_link(link)(jnp.asarray(p)))
    got = tlinks.convert_to_link(link)(torch.as_tensor(p)).numpy()
    # f32 log of the same clipped quotient: a few ulp between libms
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tlinks.convert_to_link_np(link)(p.astype(np.float64)),
                                  jlinks.convert_to_link_np(link)(p.astype(np.float64)))


def test_link_rejects_unknown():
    with pytest.raises(ValueError):
        tlinks.convert_to_link("probit")


# ---------------------------------------------------------------------------
# predictors


def test_sklearn_lift_matches_predict_proba():
    from distributedkernelshap_tpu.utils import load_data, load_model

    clf = load_model()
    data = load_data()
    bg = data["background"]["X"]["preprocessed"].toarray().astype(np.float32)
    X = data["all"]["X"]["processed"]["test"][:256].toarray().astype(np.float32)
    lifted = tpred.as_predictor(clf.predict_proba, example_dim=X.shape[1],
                                probe_data=bg, device="cpu")
    assert isinstance(lifted, tpred.LinearPredictor)
    assert lifted.activation == "softmax" and lifted.n_outputs == 2
    with torch.no_grad():
        got = lifted(torch.as_tensor(X)).numpy()
    # f32 evaluation of the f64 sklearn model
    np.testing.assert_allclose(got, clf.predict_proba(X), atol=1e-5)
    jp = jpred.as_predictor(clf.predict_proba, example_dim=X.shape[1], probe_data=bg)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jp(jnp.asarray(X)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_array_equal(lifted.W.numpy(), np.asarray(jp.W))


def test_unliftable_predictor_raises():
    """What no lift takes is wrapped, as in the reference: a torch function
    (it returns a tensor on the meta probe) as a TorchPredictor, a numpy
    function as a CallbackPredictor; only a host callable whose output
    width cannot be probed still raises."""

    torch_fn = tpred.as_predictor(lambda X: X.sum(1), example_dim=3, device="cpu")
    assert isinstance(torch_fn, tpred.TorchPredictor)
    assert (torch_fn.n_outputs, torch_fn.vector_out) == (1, False)
    numpy_fn = tpred.as_predictor(lambda X: np.asarray(X).sum(1), example_dim=3, device="cpu")
    assert isinstance(numpy_fn, tpred.CallbackPredictor)
    X = np.arange(6, dtype=np.float32).reshape(2, 3)
    for pred in (torch_fn, numpy_fn):
        np.testing.assert_array_equal(pred(torch.as_tensor(X)).numpy(), X.sum(1)[:, None])
    with pytest.raises(ValueError, match="output dim"):
        tpred.as_predictor(lambda X: np.asarray(X).sum(1), device="cpu")


def test_linear_predictor_from_numpy_matches_jax():
    rng = np.random.default_rng(1)
    W = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    X = rng.normal(size=(20, 6)).astype(np.float32)
    for act in ("identity", "softmax", "sigmoid"):
        jp = jpred.LinearPredictor(W, b, act)
        tp = linear_predictor_from_numpy(np.asarray(jp.W), np.asarray(jp.b), act,
                                         device="cpu")
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jp(jnp.asarray(X)))
        np.testing.assert_allclose(tp(torch.as_tensor(X)).numpy(), ref,
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# _ey_linear and the fused kernel's plain version


def _linear_problem(B, S, N, M, K, seed=0):
    rng = np.random.default_rng(seed)
    D = 2 * M
    X = rng.normal(size=(B, D)).astype(np.float32)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    W = rng.normal(size=(D, K)).astype(np.float32)
    b = rng.normal(size=(K,)).astype(np.float32)
    G = np.zeros((M, D), np.float32)
    for m in range(M):
        G[m, 2 * m:2 * m + 2] = 1.0
    mask = (rng.random(size=(S, M)) < 0.5).astype(np.float32)
    bgw = rng.random(N).astype(np.float32)
    bgw /= bgw.sum()
    return X, bg, W, b, G, mask, bgw


@pytest.mark.parametrize("K,activation", [
    (2, "identity"), (2, "softmax"), (3, "softmax"), (7, "softmax"),
    (1, "sigmoid"), (2, "sigmoid")])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ey_linear_matches_jax(K, activation, use_kernel):
    B, S, N, M = 9, 70, 11, 5
    X, bg, W, b, G, mask, bgw = _linear_problem(B, S, N, M, K, seed=K)
    chunk = 8      # several coalition chunks, the last one ragged
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jexp._ey_linear(
            jnp.asarray(W), jnp.asarray(b), activation, jnp.asarray(X),
            jnp.asarray(bg), jnp.asarray(bgw), jnp.asarray(mask),
            jnp.asarray(G), chunk, use_pallas=False))
    with texp.capture_kernel_paths() as kp:
        got = texp._ey_linear(_t(W), _t(b), activation, _t(X), _t(bg), _t(bgw),
                              _t(mask), _t(G), chunk, use_kernel=use_kernel).numpy()
    expect = "einsum" if activation == "identity" else "plain"
    assert kp == {"ey": expect}
    assert got.shape == (B, S, K)
    # probabilities (or logits of O(10)) summed over N in another order
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _pallas_case(B, S, N, M, K, activation, seed, **kw):
    X, bg, W, b, G, mask, bgw = _linear_problem(B, S, N, M, K, seed=seed)
    GW = G[:, :, None] * W[None]
    XWg = np.einsum("bd,mdk->bmk", X, GW).astype(np.float32)
    bgWg = np.einsum("nd,mdk->nmk", bg, GW).astype(np.float32)
    bgW = (bg @ W + b).astype(np.float32)
    ref = np.asarray(pallas_ey(jnp.asarray(XWg), jnp.asarray(bgWg), jnp.asarray(bgW),
                               jnp.asarray(bgw), jnp.asarray(mask), activation,
                               interpret=True, **kw))
    got = tck.fused_linear_ey(_t(XWg), _t(bgWg), _t(bgW), _t(bgw), _t(mask),
                              activation).numpy()
    plain = tck.fused_linear_ey_plain(_t(XWg), _t(bgWg), _t(bgW), _t(bgw),
                                      _t(mask), activation, chunk=7).numpy()
    return ref, got, plain


@pytest.mark.parametrize("K,activation", [(2, "softmax"), (3, "softmax"),
                                          (1, "sigmoid"), (2, "sigmoid")])
def test_fused_plain_matches_pallas_interpret(K, activation):
    """The shapes of tests/test_pallas.py::test_fused_linear_ey_matches_dense."""

    launches = tck.fused_linear_ey.launches
    ref, got, plain = _pallas_case(12, 150, 9, 6, K, activation, seed=0)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(plain, ref, atol=1e-5)
    assert tck.fused_linear_ey.launches == launches  # CPU tensors never launch


def test_fused_plain_matches_pallas_multiblock_edges():
    ref, got, plain = _pallas_case(33, 700, 9, 7, 2, "softmax", seed=1, tb=16, ts=256)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(plain, ref, atol=1e-5)


def test_fused_plain_matches_pallas_covertype_shape():
    ref, got, plain = _pallas_case(40, 300, 20, 12, 7, "softmax", seed=3)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(plain, ref, atol=1e-5)


def test_fused_wrapper_rejects_bad_inputs():
    XWg, bgWg, bgW, bgw, mask = (torch.zeros(4, 3, 2), torch.zeros(5, 3, 2),
                                 torch.zeros(5, 2), torch.ones(5), torch.ones(6, 3))
    assert tck.fused_linear_ey(XWg, bgWg, bgW, bgw, mask).shape == (4, 6, 2)
    with pytest.raises(ValueError, match="identity"):
        tck.fused_linear_ey(XWg, bgWg, bgW, bgw, mask, "identity")
    with pytest.raises(TypeError, match="float32"):
        tck.fused_linear_ey(XWg.double(), bgWg, bgW, bgw, mask)
    with pytest.raises(ValueError, match="contiguous"):
        tck.fused_linear_ey(XWg, bgWg, bgW, bgw, torch.ones(3, 6).T)
    with pytest.raises(ValueError, match="shape"):
        tck.fused_linear_ey(XWg, bgWg, bgW, torch.ones(4), mask)
    # past 32 classes softmax goes on to the factored kernel's class tiles:
    # CPU tensors take the plain version, any device but the CPU and the
    # card raises at the launch; sigmoid's class limit (the grid's z axis)
    # binds before it
    K = 33
    wide = (torch.zeros(4, 3, K), torch.zeros(5, 3, K), torch.zeros(5, K), bgw, mask)
    assert tck.fused_linear_ey(*wide).shape == (4, 6, K)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tck.fused_linear_ey(*(t.to("meta") for t in wide))
    K = tck.MAX_SIGMOID_K + 1
    widest = [torch.zeros(4, 3, K, device="meta"), torch.zeros(5, 3, K, device="meta"),
              torch.zeros(5, K, device="meta"), bgw.to("meta"), mask.to("meta")]
    with pytest.raises(ValueError, match="at most"):
        tck.fused_linear_ey(*widest, "sigmoid")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tck.fused_linear_ey(*widest, "softmax")


def test_ey_linear_kernel_branch_never_gives_way_to_plain():
    """With the kernel asked for, tensors off the CPU reach the wrapper at any
    class width: past 32 classes they go on to the launch (which raises off
    the card) instead of running the plain version.  The meta device stands
    in for the card here."""

    K = 33
    X, bg, W, b, G, mask, bgw = _linear_problem(4, 6, 5, 3, K, seed=0)
    meta = [_t(a).to("meta") for a in (W, b, X, bg, bgw, mask, G)]
    W_, b_, X_, bg_, bgw_, mask_, G_ = meta
    with pytest.raises(ValueError, match="cuda or cpu"):
        texp._ey_linear(W_, b_, "softmax", X_, bg_, bgw_, mask_, G_, 8,
                        use_kernel=True)
    got = texp._ey_linear(*(_t(a) for a in (W, b)), "softmax",
                          *(_t(a) for a in (X, bg, bgw, mask, G)), 8, use_kernel=True)
    assert got.shape == (4, 6, K)


def test_kernel_source_is_packaged_and_named_by_digest():
    src = tck.CSRC_DIR / "fused_linear_ey.cu"
    assert src.exists()
    text = src.read_text()
    assert "pallas_kernels.py:fused_linear_ey" in text
    assert "constexpr float kTau = 0x1p-100f;" in text and tck.ey_softmax_tau() == 2.0 ** -100
    assert f"kMaxGridZ = {tck.MAX_SIGMOID_K};" in text
    path = tck.library_path("fused_linear_ey")
    assert path.parent == tck.BUILD_DIR and path.suffix == ".so"


# ---------------------------------------------------------------------------
# the constrained WLS solve


@pytest.mark.parametrize("M", [1, 2, 6, 12])
def test_wls_solve_matches_jax(M):
    rng = np.random.default_rng(M)
    plan = jcoal.coalition_plan(M, nsamples=60, seed=1)
    B, K = 5, 3
    S = plan.n_rows
    ey_adj = rng.normal(size=(B, S, K)).astype(np.float32)
    fxe = rng.normal(size=(B, K)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jexp._wls_solve(jnp.asarray(plan.mask), jnp.asarray(plan.weights),
                                         jnp.asarray(ey_adj), jnp.asarray(fxe), 1e-6))
    got = texp._wls_solve(_t(plan.mask), _t(plan.weights), _t(ey_adj), _t(fxe),
                          1e-6).numpy()
    assert got.shape == (B, K, M)
    # the Gram matrix is well conditioned here: f32 solve agreement
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), fxe, atol=1e-5)


# ---------------------------------------------------------------------------
# isolation and device policy


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (walked, so that each new one is covered),
    ``chip_smoke`` and each ``scripts/torch_*.py`` import in one fresh
    process that then holds nothing of JAX, the JAX package, pandas or
    scikit-learn."""

    code = (
        "import glob, importlib, os, pkgutil, sys\n"
        "import distributedkernelshap_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "mods += ['chip_smoke'] + ['scripts.' + os.path.basename(p)[:-3] "
        "for p in sorted(glob.glob('scripts/torch_*.py'))]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'distributedkernelshap_tpu', 'pandas', 'sklearn')]\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n")
    repo = tck.CSRC_DIR.parent.parent
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(repo))
    assert res.returncode == 0, res.stderr
    # the walk reached every source file of the package
    imported = set(res.stdout.split())
    pkg_dir = tck.CSRC_DIR.parent
    for path in pkg_dir.rglob("*.py"):
        parts = path.relative_to(repo).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if len(parts) > 1:
            assert ".".join(parts) in imported, parts
    assert {"chip_smoke", "scripts.torch_lint", "scripts.torch_health_check",
            "scripts.torch_observability_check"} <= imported


def test_entry_points_raise_without_gpu_or_device(monkeypatch):
    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W, b = np.ones((3, 2), np.float32), np.zeros(2, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.LinearPredictor(W, b, "softmax")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelShap(lambda X: X)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelExplainerEngine(tpred.LinearPredictor(W, b, "softmax", device="cpu"),
                              np.zeros((4, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linear_predictor_from_numpy(W, b, "softmax")
    ks = KernelShap(tpred.LinearPredictor(W, b, "softmax", device="cpu"), device="cpu")
    assert ks.device == CPU
