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
behind a fan-in proxy on ``--port`` (``serving/replicas.py``); with
``--pod_procs P`` above 1 each replica unit is a pod of P processes.
``--coordinator host:port --num_processes P --process_id k`` makes this
process member k of a multi-process pod (``serving/multihost.py``): rank
0 serves HTTP, the others join each device call through the broadcast
protocol; under ``torchrun`` the three come from the environment.
SIGTERM and SIGINT stop the server or the fleet cleanly; a pod member
ignores them until it knows its rank, and the lead then drains before it
releases the followers.
"""

import argparse
import logging
import signal
import threading

from distributedkernelshap_tpu_torch.serving.replica_worker import (
    adult_factory,
    checkpoint_factory,
    resolve_factory,
)
from distributedkernelshap_tpu_torch.parallel.mesh import _launch_from_env
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
    parser.add_argument("--coordinator", default=None, type=str,
                        help="Multi-process pod: the rendezvous address "
                             "host:port (rank 0 hosts the store).  Every "
                             "member runs this entry; process 0 serves "
                             "HTTP, the rest join each device call via the "
                             "broadcast protocol (serving/multihost.py).")
    parser.add_argument("--num_processes", default=None, type=int)
    parser.add_argument("--process_id", default=None, type=int)
    parser.add_argument("--max_rows", default=None, type=int,
                        help="Multi-process broadcast slot (rows per "
                             "stacked batch); default 256.")
    parser.add_argument("--replicate_results", action="store_true",
                        help="Multi-process only: gather results at "
                             "dispatch so the broadcast protocol PIPELINES "
                             "device calls; the default, kept as an "
                             "explicit no-op — see --lockstep.")
    parser.add_argument("--lockstep", action="store_true",
                        help="Multi-process only: opt OUT of the pipelined "
                             "default (replicate_results=False) and serve "
                             "one device call at a time.")
    parser.add_argument("--coalition_parallel", default=1, type=int,
                        help="Multi-process only: shard the hot path 2D "
                             "(batch x coalition) across the pod's mesh; a "
                             "coalition group may span processes.")
    parser.add_argument("--pod_procs", default=1, type=int,
                        help="With --replica_procs: processes per replica "
                             "UNIT — each replica becomes a multi-process "
                             "pod (lead + followers over a local "
                             "coordinator) that the proxy/supervisor/"
                             "autoscaler treat as one citizen "
                             "(serving/replicas.py).")
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
    if args.coordinator is not None and (args.num_processes is None
                                         or args.process_id is None):
        parser.error("--coordinator needs --num_processes and --process_id "
                     "(under torchrun, omit all three)")
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

    def _load_deployment_args():
        # ONE definition of the deployment tuple, shared with the replica
        # workers, so a pod never serves a different explainer than the
        # single-process modes: an explicit --factory wins, then
        # --checkpoint (rebuilt through the ctor tuple so every pod
        # process re-fits identically), else the default Adult deployment
        if args.factory:
            return resolve_factory(args.factory)()
        if args.checkpoint:
            return checkpoint_factory(args.checkpoint)
        return adult_factory()

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
        unit = "pods" if args.pod_procs > 1 else "worker processes"
        banner = (f"replica serving on "
                  f"{manager.proxy.host}:{manager.proxy.port} "
                  f"({args.replica_procs} {unit}"
                  + (f" x {args.pod_procs} processes" if args.pod_procs > 1
                     else "") + ")")
        on_stop = manager.stop
    elif args.coordinator is not None or _launch_from_env() is not None:
        # a pod member: every member runs this same entry (SPMD).  A
        # pod-wide SIGTERM must not kill followers before the lead
        # broadcasts shutdown — their orderly exit IS that broadcast — so
        # EVERY member ignores the signals until it knows its rank; the
        # lead reinstalls its drain-then-stop handler at the block below
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)

        from distributedkernelshap_tpu_torch.parallel.mesh import (
            initialize_multihost,
            local_device_count,
            process_count,
            process_index,
        )
        from distributedkernelshap_tpu_torch.serving.multihost import serve_multihost

        initialize_multihost(args.coordinator, args.num_processes, args.process_id)
        predictor, background, ctor_kwargs, fit_kwargs = _load_deployment_args()
        # every device of every member: each member lays out its own
        # visible cards (one copy of the CPU off the card)
        opts = {"n_devices": process_count() * max(1, local_device_count())}
        if args.coalition_parallel > 1:
            opts["coalition_parallel"] = args.coalition_parallel
        if args.lockstep:
            opts["replicate_results"] = False
        # pipelined (replicate_results=True) is serve_multihost's default
        server = serve_multihost(
            predictor, background, ctor_kwargs, fit_kwargs, opts,
            host=args.host, port=args.port,
            max_batch_size=args.max_batch_size,
            max_rows=args.max_rows if args.max_rows is not None else 256,
            explain_kwargs=explain_kwargs,
            pipeline_depth=args.pipeline_depth or None,
        )
        if server is None:
            logging.info("follower %d released; exiting", process_index())
            return
        banner = (f"multi-process serving on {server.host}:{server.port} "
                  f"(lead of {process_count()} processes)")

        def on_stop():
            # drain handshake: stop accepting, flush in-flight broadcast
            # dispatches, THEN broadcast shutdown — followers must never be
            # left in a half-finished collective
            server.model.drain_and_shutdown(server)
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
        predictor, background, ctor_kwargs, fit_kwargs = _load_deployment_args()
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
