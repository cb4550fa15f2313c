"""One replica process: a single-device :class:`ExplainerServer` built
from a ``module:function`` factory (port of
``distributedkernelshap_tpu/serving/replica_worker.py``).

Spawned by :class:`~distributedkernelshap_tpu_torch.serving.replicas.ReplicaManager`
(``CUDA_VISIBLE_DEVICES`` pins the worker to one card before torch
initialises CUDA; several workers may share a card) or run standalone:

    python -m distributedkernelshap_tpu_torch.serving.replica_worker \
        --factory distributedkernelshap_tpu_torch.serving.replica_worker:adult_factory \
        --port 8001

A factory returns ``(predictor, background_data, constructor_kwargs,
fit_kwargs)`` — the reference's Ray Serve backend constructor tuple
(``explainers/wrappers.py:10-37``), same shape ``serve_explainer`` takes.
The worker binds its device from the constructor arguments, as
``serve_explainer`` does: the card unless the factory asks for the CPU
(``constructor_kwargs["device"] = "cpu"``).  A worker that asks for a
card it cannot see exits non-zero with the port's device error — the
supervisor counts that as a crash; no worker carries on on the CPU.
"""

import argparse
import importlib
import logging
import signal
import threading


def adult_factory():
    """The default Adult deployment tuple ``(predictor, background,
    ctor_kwargs, fit_kwargs)`` (same tuple as ``serving/main.py``).  The
    cached model is a scikit-learn estimator: without scikit-learn this
    raises an ``ImportError`` that names the mode."""

    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the default Adult deployment unpickles a scikit-learn model, "
            "and scikit-learn is not installed; serve a saved explainer "
            "with --checkpoint or a deployment with --factory") from e
    from distributedkernelshap_tpu_torch.utils import (
        data_provenance,
        load_data,
        load_model,
    )

    data = load_data()
    predictor = load_model()
    group_names, groups = data["all"]["group_names"], data["all"]["groups"]
    return (predictor, data["background"]["X"]["preprocessed"],
            {"link": "logit", "feature_names": group_names, "seed": 0},
            {"group_names": group_names, "groups": groups,
             "data_provenance": data_provenance(data)})


def synthetic_factory():
    """A tiny deterministic logistic model on synthetic data — fast to fit,
    no dataset fetch; a smoke deployment.  Fits with scikit-learn, and
    raises a named ``ImportError`` without it."""

    import numpy as np

    try:
        from sklearn.linear_model import LogisticRegression
    except ImportError as e:
        raise ImportError(
            "synthetic_factory fits a scikit-learn LogisticRegression, and "
            "scikit-learn is not installed; pass a factory of your own") from e

    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    clf = LogisticRegression(max_iter=200).fit(X, y)
    return (clf, X[:32], {"link": "logit", "seed": 0}, {})


def checkpoint_factory(path: str):
    """The ctor tuple behind a ``KernelShap.save`` checkpoint: rebuilds
    ``(predictor, background, ctor_kwargs, fit_kwargs)`` from the saved
    state so the model is re-fitted through the NORMAL constructor path
    (the reference's route for multi-process pods; ``serving.main
    --checkpoint`` keeps using ``KernelShap.load``).  The saved engine
    config carries the device the checkpoint was made on."""

    import pickle

    from distributedkernelshap_tpu_torch.data import Data

    with open(path, "rb") as f:
        state = pickle.load(f)
    bg = state["background_data"]
    fit_kwargs = {}
    if isinstance(bg, Data):
        # grouped/weighted backgrounds round-trip through fit's grouping
        # args; the raw matrix feeds the constructor path like any other
        if state.get("use_groups"):
            fit_kwargs["group_names"] = list(bg.group_names)
            fit_kwargs["groups"] = bg.groups
            weights = getattr(bg, "weights", None)
            if weights is not None:
                fit_kwargs["weights"] = weights
        bg = bg.data
    ctor_kwargs = {
        "link": state["link"],
        "feature_names": state["feature_names"],
        "categorical_names": state["categorical_names"],
        "task": state["task"],
        "seed": state["seed"],
        "engine_config": state.get("engine_config"),
    }
    provenance = (state.get("meta") or {}).get("data_provenance")
    if provenance is not None:
        fit_kwargs["data_provenance"] = provenance
    return state["predictor"], bg, ctor_kwargs, fit_kwargs


def resolve_factory(spec: str):
    """``module:function`` → the function."""

    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"--factory must be 'module:function', got {spec!r}")
    return getattr(importlib.import_module(mod_name), fn_name)


def _deployment(factory):
    """The factory's deployment tuple, or the port's device error where it
    asks for a card this process cannot see: the constructor's ``device``
    (else its ``engine_config.device``, else the default, the card), or a
    factory that fails building on a host that shows no card."""

    import torch

    from distributedkernelshap_tpu_torch.utils import resolve_device

    try:
        deployment = factory()
        ctor_kwargs = deployment[2]
        device = ctor_kwargs.get("device")
        if device is None:
            device = getattr(ctor_kwargs.get("engine_config"), "device", None)
        device = resolve_device(device)
    except Exception as e:
        if torch.cuda.is_available():
            raise
        raise RuntimeError(
            f"no CUDA device is available and the deployment asks for one "
            f"({type(e).__name__}: {e}); pass device='cpu' to run the "
            f"PyTorch port on the CPU") from e
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the deployment asks for {device} and no CUDA device is "
            "available; pass device='cpu' to run the PyTorch port on the CPU")
    return deployment


def main():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s replica %(levelname)s %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--factory", required=True,
                        help="module:function returning (predictor, "
                             "background, ctor_kwargs, fit_kwargs)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", required=True, type=int)
    parser.add_argument("--max_batch_size", default=10, type=int)
    parser.add_argument("--pipeline_depth", default=0, type=int,
                        help="0 = self-calibrate at startup")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the warmup ladder (replicas default it "
                             "ON — a restarted worker otherwise re-pays "
                             "every bucket's first call on live traffic; "
                             "DKS_WARMUP=0 also disables)")
    parser.add_argument("--staging", action="store_true",
                        help="enable the double-buffered host-to-device "
                             "staging pipeline (default: resolved from "
                             "DKS_STAGING, off unless truthy)")
    args = parser.parse_args()

    factory = resolve_factory(args.factory)

    # fault injection (chaos harness): resolved from DKS_FAULTS before the
    # heavyweight imports so a bad spec fails the worker loudly at startup.
    # Specs carrying replica=K are filtered against DKS_REPLICA_INDEX, so
    # one fleet-wide env value scripts per-replica behaviour.
    from distributedkernelshap_tpu_torch.resilience.faults import from_env

    fault_injector = from_env()

    # CUDA initialises after the factory resolves, with
    # CUDA_VISIBLE_DEVICES already in the environment from the manager —
    # this process sees the ONE card it was pinned to
    from distributedkernelshap_tpu_torch.serving.server import (
        resolve_warmup_env,
        serve_explainer,
    )

    # replica workers default the warmup ladder ON (the supervisor makes
    # restarts routine, and a restarted worker must not re-pay its bucket
    # builds on live traffic); --no-warmup or DKS_WARMUP=0 opt out, and
    # the /healthz "warming" readiness gate keeps the prober/supervisor
    # away while the ladder runs
    warmup = False if args.no_warmup else resolve_warmup_env(default=True)

    predictor, background, ctor_kwargs, fit_kwargs = _deployment(factory)
    server = serve_explainer(
        predictor, background, ctor_kwargs, fit_kwargs,
        host=args.host, port=args.port,
        max_batch_size=args.max_batch_size,
        pipeline_depth=args.pipeline_depth or None,
        fault_injector=fault_injector, warmup=warmup,
        # --staging forces it on; otherwise None defers to DKS_STAGING
        staging=True if args.staging else None)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    logging.info("replica serving on %s:%d", server.host, server.port)
    stop.wait()
    server.stop()


if __name__ == "__main__":
    main()
