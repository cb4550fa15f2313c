"""Serving entry point: fit the default Adult explainer (or load a saved
one) and serve it.

Port of ``distributedkernelshap_tpu/serving/main.py``, single-process
modes: ``python -m distributedkernelshap_tpu_torch.serving.main
--checkpoint <path>`` serves a ``KernelShap.save`` checkpoint on the device
its ``engine_config.device`` names (a checkpoint saved on the card loads on
the card), ``--factory module:function`` serves a deployment tuple, and
with neither it fits the Adult deployment, which needs the cached Adult
files and scikit-learn to unpickle the model.  The multi-host
(``--coordinator``) and replica-fleet (``--replica_procs``,
``--pod_procs``) modes raise ``NotImplementedError``: they wait for
ROADMAP.md queue A items 10 and 12c.  SIGTERM and SIGINT stop the server
cleanly.
"""

import argparse
import importlib
import logging
import signal
import threading

from distributedkernelshap_tpu_torch.serving.server import serve_explainer

logging.basicConfig(level=logging.INFO)


def adult_factory():
    """The default Adult deployment tuple ``(predictor, background,
    ctor_kwargs, fit_kwargs)`` (reference ``serving/replica_worker.py:
    24-39``).  The cached model is a scikit-learn estimator: without
    scikit-learn this raises an ``ImportError`` that names the mode."""

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


def resolve_factory(spec: str):
    """``module:function`` → the function (reference
    ``serving/replica_worker.py:101-105``)."""

    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"--factory must be 'module:function', got {spec!r}")
    return getattr(importlib.import_module(mod_name), fn_name)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", default=8000, type=int)
    parser.add_argument("--max_batch_size", default=32, type=int)
    parser.add_argument("--pipeline_depth", default=0, type=int,
                        help="In-flight device batches (overlapped D2H); the "
                             "reference's num_replicas analog. 0 (default) "
                             "self-calibrates at startup.")
    parser.add_argument("--checkpoint", default=None, type=str,
                        help="Serve a saved explainer (KernelShap.save) "
                             "instead of fitting the default Adult one.")
    parser.add_argument("--exact", action="store_true",
                        help="Serve exact interventional TreeSHAP responses "
                             "(lifted tree ensembles with raw-margin outputs "
                             "and link='identity' only; ops/treeshap.py).")
    parser.add_argument("--factory", default=None, type=str,
                        help="module:function returning (predictor, "
                             "background, ctor_kwargs, fit_kwargs) "
                             "(default: the Adult deployment).")
    # the reference's multi-host and replica-fleet modes: accepted so that
    # their use names what is missing, not an unknown argument
    queued = " Not in the port yet: raises NotImplementedError."
    parser.add_argument("--coordinator", default=None, type=str,
                        help="Multi-host coordinator address (ROADMAP.md "
                             "queue A item 10)." + queued)
    parser.add_argument("--pod_procs", default=1, type=int,
                        help="Processes per replica unit (ROADMAP.md queue "
                             "A item 12c)." + queued)
    parser.add_argument("--replica_procs", default=0, type=int,
                        help="Replica server processes behind a fan-in "
                             "proxy (ROADMAP.md queue A item 12c)." + queued)
    args = parser.parse_args()
    explain_kwargs = {"nsamples": "exact"} if args.exact else None

    if args.factory and args.checkpoint:
        parser.error("--factory and --checkpoint both name a deployment; "
                     "pick one")
    if args.coordinator is not None:
        raise NotImplementedError(
            "--coordinator (multi-host serving) waits for the multi-GPU "
            "port (ROADMAP.md queue A item 10)")
    if args.replica_procs or args.pod_procs != 1:
        raise NotImplementedError(
            "--replica_procs / --pod_procs (the replica fleet behind a "
            "fan-in proxy) wait for ROADMAP.md queue A item 12c")
    if args.checkpoint:
        from distributedkernelshap_tpu_torch.kernel_shap import KernelShap
        from distributedkernelshap_tpu_torch.serving.server import ExplainerServer
        from distributedkernelshap_tpu_torch.serving.wrappers import BatchKernelShapModel

        # the device resolves from the checkpoint's engine_config
        explainer = KernelShap.load(args.checkpoint)
        model = BatchKernelShapModel.from_explainer(explainer,
                                                    explain_kwargs=explain_kwargs)
        server = ExplainerServer(model, host=args.host, port=args.port,
                                 max_batch_size=args.max_batch_size,
                                 pipeline_depth=args.pipeline_depth or None).start()
    else:
        factory = resolve_factory(args.factory) if args.factory else adult_factory
        predictor, background, ctor_kwargs, fit_kwargs = factory()
        server = serve_explainer(
            predictor, background, ctor_kwargs, fit_kwargs,
            host=args.host, port=args.port, max_batch_size=args.max_batch_size,
            pipeline_depth=args.pipeline_depth or None,
            explain_kwargs=explain_kwargs,
        )
    banner = f"serving on {server.host}:{server.port} — Ctrl-C to stop"
    on_stop = server.stop

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    logging.info(banner)
    stop.wait()
    on_stop()


if __name__ == "__main__":
    main()
