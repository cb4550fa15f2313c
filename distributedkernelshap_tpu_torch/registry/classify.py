"""The ONE engine-path classifier for registered models.

Before the registry, the decision "which evaluation path should serve this
predictor" lived inline in ``serving/wrappers.KernelShapModel.
_resolve_explain_path`` (PR 7 added the exact-TreeSHAP arm, PR 9 the exact
tensor-network arm) and nothing named the linear fast path at all — it was
an emergent property of the engine's ``linear_decomposition`` branch.  The
multi-tenant gateway needs the decision as a first-class, reusable fact:
ingest classifies every registered ``(model_id, version)`` once, the
serving wrappers keep auto-selecting from the same logic, and ``/statusz``
/ ``dks_registry_models`` render the result per tenant.

Paths (:data:`ENGINE_PATHS`):

* ``linear`` — the predictor exposes a ``(W, b, activation)``
  decomposition, so the engine collapses the KernelSHAP synthetic tensor
  into three einsums and small batches ride the plan-constant device
  cache (the MXU fast path; estimator still sampled, but the plan is
  closed-form cheap).
* ``exact_tree`` — lifted tree ensemble with raw-margin outputs at
  identity link: closed-form interventional TreeSHAP, no sampling.
* ``exact_tn`` — tensor-train-structured predictor passing every
  readiness gate (``ops/tensor_shap.tn_exact_ready``): exact Shapley by
  DP contraction.
* ``deepshap`` — predictor carrying a lifted neural graph whose every
  node has an attribution rule (``attribution/deepshap.py``): DeepSHAP
  multiplier backprop, sampling-free — exact Shapley for
  coalition-stable piecewise-linear nets, exact-completeness DeepLIFT
  attribution otherwise.
* ``sampled`` — the generic masked-EY KernelSHAP estimator (everything
  else, including TT predictors and neural graphs that fail a readiness
  gate — the reason is carried so callers can count it).
"""

from typing import NamedTuple, Optional

ENGINE_PATHS = ("linear", "exact_tree", "exact_tn", "deepshap", "sampled")


class PathDecision(NamedTuple):
    """``path`` is one of :data:`ENGINE_PATHS`; ``reason`` is a short
    human phrase for /statusz and logs; ``tn_fallback`` carries the
    ``tn_exact_ready`` reason when a TT-structured predictor stays
    sampled, ``deepshap_fallback`` the ``deepshap_ready`` reason when a
    graph-bearing predictor does (callers decide whether to count them —
    the serving wrapper does, a pure classification probe does not)."""

    path: str
    reason: str
    tn_fallback: Optional[str] = None
    deepshap_fallback: Optional[str] = None


def serving_engine(model):
    """The fitted engine behind a serving model / explainer / engine
    (``DistributedExplainer`` wraps the real engine one level down), or
    ``None`` when ``model`` exposes none — one extraction for the
    wrappers, the registry and the classifier."""

    explainer = getattr(model, "explainer", model)
    engine = getattr(explainer, "_explainer", explainer)
    if engine is not None and not hasattr(engine, "predictor"):
        engine = getattr(engine, "engine", None)
    return engine if hasattr(engine, "predictor") else None


def share_eligible(model):
    """The fitted engine behind ``model`` IF the deployment qualifies for
    cross-tenant shared-program dispatch, else ``None``.

    Sharing coalesces several tenants' request rows into ONE padded
    device call, so eligibility is exactly the bit-identity gate
    (docs/MULTITENANCY.md): the serving wrapper must declare per-row
    reduction scope (``per_row_reduction`` — every request's phi depends
    only on its own rows plus X-independent constants, true of all four
    engine paths but NOT of arbitrary stub models), and the pinned
    explain options must be limited to ``nsamples`` — ``interactions``
    and active ``l1_reg`` ride sync fallbacks with request-coupled
    control flow.  The engine itself carries the compatibility facts
    (content fingerprint, plan seed, config) that
    :func:`~distributedkernelshap_tpu_torch.ops.explain.shared_program_key`
    digests into the share key two tenants must MATCH on."""

    if not getattr(model, "per_row_reduction", False):
        return None
    kwargs = getattr(model, "explain_kwargs", None)
    if kwargs is None:
        return None
    if any(v for k, v in kwargs.items() if k != "nsamples"):
        return None
    return serving_engine(model)


def classify_path(model, link: Optional[str] = None, G=None,
                  target_chunk_elems: Optional[int] = None) -> PathDecision:
    """Classify ``model`` onto its engine path.

    ``model`` may be a fitted serving model (``KernelShapModel``-like), a
    fitted explainer/engine, or a bare predictor — for a bare predictor,
    ``link``/``G`` default to ``"identity"``/``None`` (no grouping), the
    registry's ingest-time view.  Never raises: a probe failure
    classifies as ``sampled`` with the failure named in ``reason``.
    """

    try:
        return _classify(model, link, G, target_chunk_elems)
    except Exception as e:  # classification must never fail an ingest
        return PathDecision("sampled", f"classification probe failed: {e}")


def _classify(model, link, G, target_chunk_elems) -> PathDecision:
    from distributedkernelshap_tpu_torch.ops.tensor_shap import (
        supports_exact_tn,
        tn_exact_ready,
    )
    from distributedkernelshap_tpu_torch.ops.treeshap import supports_exact

    engine = serving_engine(model)
    if engine is not None:
        pred = engine.predictor
        if link is None:
            link = engine.config.link
        if G is None:
            G = engine.G
        if target_chunk_elems is None:
            target_chunk_elems = engine.config.shap.target_chunk_elems
    else:
        pred = model
    if link is None:
        link = "identity"

    if supports_exact(pred):
        if link == "identity":
            return PathDecision(
                "exact_tree",
                f"lifted {type(pred).__name__} with raw-margin outputs")
        return PathDecision(
            "sampled", f"tree ensemble at link={link!r} (exact TreeSHAP "
                       "explains the raw margin only)")
    if supports_exact_tn(pred):
        import numpy as np

        G_eff = G
        if G_eff is None:
            # ingest-time classification of a bare TT predictor: identity
            # grouping, one site per feature — the shape the contraction
            # actually serves
            M = getattr(pred, "n_features", None)
            struct = getattr(pred, "tt_structure", lambda: None)()
            if M is None and struct is not None:
                M = struct["M"]
            G_eff = np.eye(int(M), dtype=np.float32) if M else None
        reason = tn_exact_ready(pred, link, G_eff, target_chunk_elems) \
            if G_eff is not None else "grouping"
        if reason is None:
            return PathDecision(
                "exact_tn",
                f"tensor-train structure (rank "
                f"{pred.tt_structure()['rank']}) at identity link")
        return PathDecision(
            "sampled", f"TT structure present but not exact-ready "
                       f"({reason})", tn_fallback=reason)
    from distributedkernelshap_tpu_torch.attribution.deepshap import (
        graph_spec_of,
        deepshap_ready,
    )

    if graph_spec_of(pred) is not None:
        reason = deepshap_ready(pred, link, G, target_chunk_elems)
        if reason is None:
            spec = pred.graph_spec()
            return PathDecision(
                "deepshap",
                f"lifted neural graph ({len(spec.nodes)} nodes, "
                f"D={spec.input_dim}): DeepSHAP backprop attribution")
        return PathDecision(
            "sampled", f"neural graph present but not DeepSHAP-ready "
                       f"({reason})", deepshap_fallback=reason)
    if getattr(pred, "linear_decomposition", None) is not None:
        W, _, activation = pred.linear_decomposition
        return PathDecision(
            "linear", f"linear decomposition (D={int(W.shape[0])}, "
                      f"K={int(W.shape[1])}, {activation}) — "
                      "plan-constant fast path")
    return PathDecision(
        "sampled", f"generic predictor ({type(pred).__name__}): "
                   "masked-EY sampled estimator")
