"""Serving entry point: fit the default Adult explainer (or load a saved
one) and serve it, from one process or from a replica fleet.

Port of ``distributedkernelshap_tpu/serving/main.py``:
``python -m distributedkernelshap_tpu_torch.serving.main --checkpoint
<path>`` serves a ``KernelShap.save`` checkpoint on the device its
``engine_config.device`` names (a checkpoint saved on the card loads on
the card), ``--factory module:function`` serves a deployment tuple, and
with neither it fits the Adult deployment, which needs the cached Adult
files and scikit-learn to unpickle the model.  ``--replica_procs N``
spawns N single-device worker processes (``serving/replica_worker.py``)
behind a fan-in proxy on ``--port`` (``serving/replicas.py``).  The
multi-host modes (``--coordinator``, and ``--pod_procs`` above 1, whose
replica units are multi-process pods) raise ``NotImplementedError``: they
wait for ROADMAP.md queue A item 10.  SIGTERM and SIGINT stop the server
or the fleet cleanly.
"""

import argparse
import logging
import signal
import threading

from distributedkernelshap_tpu_torch.serving.replica_worker import (
    adult_factory,
    resolve_factory,
)
from distributedkernelshap_tpu_torch.serving.server import serve_explainer

logging.basicConfig(level=logging.INFO)


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
    # the reference's multi-host modes: accepted so that their use names
    # what is missing, not an unknown argument
    queued = " Not in the port yet: raises NotImplementedError."
    parser.add_argument("--coordinator", default=None, type=str,
                        help="Multi-host coordinator address (ROADMAP.md "
                             "queue A item 10)." + queued)
    parser.add_argument("--num_processes", default=None, type=int)
    parser.add_argument("--process_id", default=None, type=int)
    parser.add_argument("--max_rows", default=None, type=int,
                        help="Multi-host broadcast slot (ROADMAP.md queue "
                             "A item 10)." + queued)
    parser.add_argument("--replicate_results", action="store_true",
                        help="Multi-host only (ROADMAP.md queue A item "
                             "10)." + queued)
    parser.add_argument("--lockstep", action="store_true",
                        help="Multi-host only (ROADMAP.md queue A item "
                             "10)." + queued)
    parser.add_argument("--pod_procs", default=1, type=int,
                        help="With --replica_procs: processes per replica "
                             "UNIT; above 1 each unit is a multi-process "
                             "pod (ROADMAP.md queue A item 10)." + queued)
    parser.add_argument("--replica_procs", default=0, type=int,
                        help="Replica mode: spawn this many crash-isolated "
                             "single-device server PROCESSES (replica k on "
                             "card k mod the host's cards) behind a fan-in "
                             "proxy on --port (serving/replicas.py).")
    args = parser.parse_args()
    explain_kwargs = {"nsamples": "exact"} if args.exact else None

    if args.coordinator is None and (args.num_processes is not None
                                     or args.process_id is not None):
        parser.error("--num_processes/--process_id require --coordinator "
                     "(a would-be follower must never start its own server)")
    if args.pod_procs < 1:
        parser.error("--pod_procs must be >= 1")
    if args.pod_procs > 1 and not args.replica_procs:
        parser.error("--pod_procs sizes the replica UNITS of the "
                     "--replica_procs fleet; a standalone pod is "
                     "--coordinator with one process per host")
    if args.replicate_results and args.lockstep:
        parser.error("--replicate_results and --lockstep are opposites")
    if args.factory and args.checkpoint:
        parser.error("--factory and --checkpoint both name a deployment; "
                     "pick one")
    if args.replica_procs:
        if args.coordinator is not None or args.checkpoint or args.exact \
                or args.replicate_results or args.lockstep \
                or args.max_rows is not None:
            # fail loudly: a flag this mode cannot honour must never be
            # silently dropped (--pod_procs composes: each replica unit
            # becomes a pod)
            parser.error("--replica_procs is the single-host replica "
                         "fleet mode; it does not combine with "
                         "--coordinator/--checkpoint/--exact/"
                         "--replicate_results/--lockstep/--max_rows")
    if args.coordinator is not None or args.pod_procs > 1:
        raise NotImplementedError(
            "--coordinator and --pod_procs above 1 (multi-process pods) "
            "wait for the multi-GPU port (ROADMAP.md queue A item 10)")

    if args.replica_procs:
        from distributedkernelshap_tpu_torch.serving.replicas import ReplicaManager

        manager = ReplicaManager(
            args.replica_procs,
            factory=args.factory or (adult_factory.__module__
                                     + ":adult_factory"),
            max_batch_size=args.max_batch_size,
            pipeline_depth=args.pipeline_depth or None,
            pod_processes=args.pod_procs,
        ).start(proxy_port=args.port, proxy_host=args.host)
        banner = (f"replica serving on "
                  f"{manager.proxy.host}:{manager.proxy.port} "
                  f"({args.replica_procs} worker processes)")
        on_stop = manager.stop
    elif args.checkpoint:
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
        banner = f"serving on {server.host}:{server.port} — Ctrl-C to stop"
        on_stop = server.stop
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
