"""Mesh-sharded distributed explainer, one process over many devices.

Port of ``distributedkernelshap_tpu/parallel/distributed.py``.  The
reference replaces the Ray actor pool of the original DistributedKernelShap
with ONE engine whose explain function is sharded over a device mesh; this
port keeps that design and drives the mesh (``parallel/mesh.py``) from a
host loop:

* the instance axis splits over the ``data`` axis, each data shard's rows
  uploaded to its devices;
* the coalition rows (sampled path) or the background rows (exact paths)
  split over the ``coalition`` axis, and a group's partial sums are added
  on its first device (the reference's ``psum``);
* every shard runs the single-device kernel stack: ``fused_linear_ey`` on
  the linear sampled route, ``exact_tree_phi`` (dense or once per packed
  bucket) and ``exact_tree_inter`` on the exact tree paths.  On CUDA
  tensors each launches its kernel or raises;
* the host loop issues each shard's work on its device without waiting:
  CUDA launches are asynchronous, so shards on distinct cards overlap.
  Each data shard's result comes back in one packed copy
  (``pack_transfer``), and the rows are put together on the host in order.

Under several processes (``parallel/mesh.initialize_multihost``) every
process runs the same explain on the same rows and issues only the shards
it owns; partial sums that cross processes, and the results, move with
``mesh.exchange``.  A data-sharded result is gathered at the fetch (the
reference's ``process_allgather``), a ``replicate_results`` one at the
dispatch, so its fetch is local; collective-bearing fetches run serially,
in the same order on every process.

``batch`` / ``invert_permutation`` / the target and postprocess functions
are kept (pure, tested) for API parity with the reference
(``explainers/distributed.py:11-82`` of the original).
"""

import hashlib
import json
import logging
from collections import OrderedDict
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from distributedkernelshap_tpu_torch.ops.explain import (
    capture_kernel_paths,
    fetch_transfer,
    pack_transfer,
    split_shap_values,
    unpack_transfer,
)
from distributedkernelshap_tpu_torch.parallel.coalition_sharding import (
    build_coalition_sharded_fn,
    pad_coalitions,
    split_rows,
)
from distributedkernelshap_tpu_torch.parallel.mesh import (
    COALITION_AXIS,
    DATA_AXIS,
    PredictorReplicas,
    device_mesh,
    exchange,
    pad_to_multiple,
    process_count,
    replicate,
)
from distributedkernelshap_tpu_torch.utils import batch as make_batches
from distributedkernelshap_tpu_torch.utils import full_f32_matmul, resolve_device

logger = logging.getLogger(__name__)


def kernel_shap_target_fn(actor: Any, instances: tuple, kwargs: Optional[Dict] = None):
    """Dispatch one indexed work item to an explainer engine
    (pool-dispatch parity with reference ``distributed.py:52-59``)."""

    if kwargs is None:
        kwargs = {}
    return actor.get_explanation(instances, **kwargs)


def kernel_shap_postprocess_fn(ordered_result: List[Union[np.ndarray, List[np.ndarray]]]):
    """Concatenate ordered batch results (reference ``distributed.py:62-73``):
    single-output predictors yield ndarrays, multi-output predictors yield a
    per-class list."""

    if isinstance(ordered_result[0], np.ndarray):
        return np.concatenate(ordered_result, axis=0)
    n_outputs = len(ordered_result[0])
    return [
        np.concatenate([res[k] for res in ordered_result], axis=0)
        for k in range(n_outputs)
    ]


def invert_permutation(p: list) -> np.ndarray:
    """``s[p[i]] = i`` (reference ``distributed.py:76-82``).  Unused on the
    sharded path (order is preserved); kept for the pool-style dispatcher."""

    s = np.empty_like(np.asarray(p))
    s[np.asarray(p)] = np.arange(len(p))
    return s


def _engine_device(init_kwargs: dict) -> torch.device:
    """The device the engine will be built on (its config's, else the
    current CUDA device)."""

    config = init_kwargs.get('config')
    return resolve_device(getattr(config, 'device', None))


def _stream_of(t: torch.Tensor) -> Optional["torch.cuda.Stream"]:
    return torch.cuda.current_stream(t.device) if t.is_cuda else None


def _sum_in_order(group: List[Dict[str, torch.Tensor]], name: str,
                  d0: torch.device) -> torch.Tensor:
    """A data group's partial ``name`` summed on its first device in shard
    order (the reference's ``psum``; the same order on every process)."""

    acc = group[0][name]
    for part in group[1:]:
        acc = acc + part[name].to(d0)
    return acc


def _lead_predict(replicas: PredictorReplicas, mesh, rows, i: int) -> torch.Tensor:
    """f(x) of data group ``i``'s rows on its first device."""

    d0 = mesh.device(i, 0)
    return replicas.on(d0)(rows[i].to(d0))


class DistributedExplainer:
    """Shards explanation batches over a device mesh.

    Drop-in for the reference class of the same name
    (``distributed.py:85-1048``): constructed from ``distributed_opts`` + an
    engine class and its init args, exposes ``get_explanation`` and proxies
    attribute reads to the engine.

    ``distributed_opts``: ``n_devices`` (or ``n_cpus``; ``None`` = every
    device), ``batch_size`` (rows per device per slab), ``dispatch_window``,
    ``checkpoint_dir`` / ``journal_fingerprint`` (shard journaling),
    ``coalition_parallel`` (or a whole ``actor_cpu_fraction`` > 1),
    ``partitioning`` (``'shard_map'`` or ``'gspmd'``), ``replicate_results``
    and ``devices`` (this process's devices to lay out; default every
    visible CUDA device, or ``n_devices`` copies of the engine's device when
    that is the CPU, shared out over the processes; a device may repeat).
    Under several processes ``n_devices`` counts the devices of all of
    them."""

    def __init__(self,
                 distributed_opts: Dict[str, Any],
                 explainer_type: Callable,
                 init_args: tuple,
                 init_kwargs: dict):
        opts = dict(distributed_opts)
        n_devices = opts.get('n_devices') or opts.get('n_cpus')
        self.batch_size = opts.get('batch_size')
        # in-flight slab bound for the dispatch/fetch pipeline; None (the
        # default) resolves via parallel/pipeline.resolve_window
        self.dispatch_window = opts.get('dispatch_window')
        # shard-granular checkpoint/resume (resilience/journal.py): with a
        # checkpoint_dir set, every multi-call explain journals completed
        # slabs so a killed run resumes recomputing only in-flight work;
        # 'journal_fingerprint' pins the run key explicitly
        self.checkpoint_dir = opts.get('checkpoint_dir')
        self._pinned_journal_fp = opts.get('journal_fingerprint')
        #: stats of the most recent journaled run ({'path', 'completed',
        #: 'restored', 'computed'}); None when checkpointing is off
        self.last_journal_stats: Optional[Dict[str, Any]] = None
        cp = opts.get('coalition_parallel')
        frac = opts.get('actor_cpu_fraction')
        cp_from_fraction = False
        if cp is None and frac is not None and float(frac) != 1.0:
            # reference semantics: one actor spans `actor_cpu_fraction` CPUs.
            # The device analog of an actor spanning f units is f devices
            # co-operating on one explanation batch — coalition-axis sharding.
            # Fractions < 1 packed several actors onto one CPU; a device has
            # no sub-unit to pack onto, so those are ignored loudly
            if float(frac) > 1 and float(frac).is_integer():
                cp = int(frac)
                cp_from_fraction = True
                logger.info(
                    "actor_cpu_fraction=%s mapped to coalition_parallel=%d "
                    "(devices co-operating per batch)", frac, cp)
            else:
                logger.warning(
                    "actor_cpu_fraction=%s has no device analog (devices are "
                    "not subdividable; only whole fractions > 1 map to "
                    "coalition parallelism). Ignoring it — set "
                    "coalition_parallel explicitly to shard the coalition "
                    "axis across devices.", frac)
        self.coalition_parallel = int(cp or 1)
        # 'shard_map' (default) runs the single-device kernel stack in every
        # shard; 'gspmd' is the reference's A/B path, which turns its TPU
        # kernel off: here the same shard loop with the kernels' plain
        # versions (kernel_path records 'plain')
        self.partitioning = opts.get('partitioning', 'shard_map')
        if self.partitioning not in ('shard_map', 'gspmd'):
            raise ValueError(
                f"partitioning must be 'shard_map' or 'gspmd', got "
                f"{self.partitioning!r}")
        self.algorithm = opts.get('algorithm', 'kernel_shap')
        # gather phi/f(x) of every data shard onto the mesh's first device,
        # so the host makes one copy of the whole result
        self.replicate_results = bool(opts.get('replicate_results', False))

        devices = opts.get('devices')
        if devices is None:
            dev = _engine_device(init_kwargs)
            if dev.type != 'cuda':
                world = process_count()
                devices = [dev] * max(1, -(-int(n_devices or world) // world))
        try:
            self.mesh = device_mesh(n_devices, coalition_parallel=self.coalition_parallel,
                                    devices=devices)
        except ValueError:
            if not cp_from_fraction:
                raise  # an explicit coalition_parallel request must not degrade
            # alias semantics stay warn-and-degrade like the reference's knob
            logger.warning(
                "actor_cpu_fraction=%s does not divide the device count; "
                "running without coalition parallelism.", frac)
            self.coalition_parallel = 1
            self.mesh = device_mesh(n_devices, coalition_parallel=1, devices=devices)
        if self.partitioning == 'gspmd' and self.coalition_parallel > 1:
            # normalise AFTER the mesh settles, so the attribute always
            # reports the path that actually runs
            logger.warning("partitioning='gspmd' does not support "
                           "coalition_parallel>1; using shard_map.")
            self.partitioning = 'shard_map'
        self.n_data = self.mesh.shape[DATA_AXIS]
        logger.info("Mesh: %d data-parallel x %d coalition-parallel devices",
                    self.n_data, self.mesh.shape[COALITION_AXIS])

        # one engine (holds background data, predictor, coalition plans);
        # the original instead spawned n_actors replica processes
        self.engine = explainer_type(*init_args, **init_kwargs)
        self._fn_cache: Dict[Any, Any] = {}
        self._dev_cache: "OrderedDict[Any, Any]" = OrderedDict()
        self.last_raw_prediction: Optional[np.ndarray] = None
        self.last_interaction_values: Optional[List[np.ndarray]] = None
        self.last_X_fingerprint = None

    def __getattr__(self, item):
        # only called when normal lookup fails: proxy to the engine
        if item == 'engine':  # guard against recursion before __init__ completes
            raise AttributeError(item)
        return getattr(self.engine, item)

    def stage_rows(self, X, nsamples=None, l1_reg='auto',
                   interactions: bool = False):
        """Decline serving-side row staging: the sharded dispatch re-pads
        per mesh layout (``_pad_sharded``), so a buffer staged with the
        single-engine bucketing would not fit it.  Defined explicitly so
        ``__getattr__`` cannot proxy the inner engine's ``stage_rows``."""

        del X, nsamples, l1_reg, interactions
        return None

    # ------------------------------------------------------------------ #

    def reset_device_state(self) -> None:
        """Drop the sharded functions + device-resident constants AND the
        wrapped engine's caches — the serving watchdog's recovery hook."""

        self._fn_cache.clear()
        self._dev_cache.clear()
        self.engine.reset_device_state()

    def _sharded_fn(self):
        key = 'fn'
        if key not in self._fn_cache:
            # the body is the single-device kernel stack applied to local
            # shapes, so the chunk budget needs no adjustment; with
            # coalition size 1 the partial-sum reduction is a no-op.  The
            # reference's 'gspmd' path turns its TPU kernel off (a
            # pallas_call has no GSPMD partitioning rule): the same shard
            # loop here runs the kernels' plain versions
            shap = replace(self.engine.config.shap, link=self.engine.config.link)
            if self.partitioning == 'gspmd':
                shap = replace(shap, use_kernel=False)
            self._fn_cache[key] = build_coalition_sharded_fn(
                self.engine.predictor, shap, self.mesh,
                replicate_results=self.replicate_results)
        return self._fn_cache[key]

    #: bound on device-constant cache entries (matches the engine's)
    _DEV_CACHE_MAX_ENTRIES = 8

    def _device_args(self, plan):
        """The per-fit constants on each distinct device of the mesh (one
        upload, reused across explain calls), the coalition rows padded to
        the coalition axis.  Keyed by the plan's CONTENT fingerprint and
        LRU-bounded (reference ``distributed.py:273-294``)."""

        from distributedkernelshap_tpu_torch.ops.coalitions import plan_fingerprint

        key = plan_fingerprint(plan)
        if key not in self._dev_cache:
            engine = self.engine
            mask, weights = pad_coalitions(
                torch.as_tensor(np.asarray(plan.mask, np.float32)),
                torch.as_tensor(np.asarray(plan.weights, np.float32)),
                self.mesh.shape[COALITION_AXIS])
            devices = self.mesh.distinct_devices
            self._dev_cache[key] = tuple(
                replicate(torch.as_tensor(np.asarray(a, np.float32)), devices)
                for a in (engine.background, engine.bg_weights, mask, weights,
                          engine.G))
            while len(self._dev_cache) > self._DEV_CACHE_MAX_ENTRIES:
                self._dev_cache.popitem(last=False)
        else:
            self._dev_cache.move_to_end(key)
        return self._dev_cache[key]

    def _pad_sharded(self, X: np.ndarray):
        """``(padded_X, original_B)``: bucket to the engine's batch ladder,
        then to a whole number of device rows.  Shared by every sharded
        dispatch path so their padding can never diverge."""

        engine = self.engine
        B = X.shape[0]
        bucket = engine._bucket(B) if engine.config.bucket_batches else B
        padded, _ = pad_to_multiple(max(bucket, self.n_data), self.n_data)
        if padded != B:
            X = np.concatenate([X, np.tile(X[-1:], (padded - B, 1))], 0)
        return X, B

    def _dispatch_call(self, fn, X: np.ndarray, args, replicated: bool = False):
        """Pad ``X`` to a whole number of device rows, issue ``fn`` on the
        mesh WITHOUT waiting (CUDA launches are asynchronous) and return
        ``(packed, B, padded_B, has_interactions, replicated)`` for
        :meth:`_fetch_sharded`: ``packed`` maps each data shard this process
        holds (the one slot 0 of a replicated result) to its
        :func:`pack_transfer` tensor and the stream it was made on.
        ``replicated`` records whether THIS function gathered its outputs
        (the sampled path under ``replicate_results``; the exact paths'
        outputs stay data-sharded whatever the flag), and the fetch keys
        its cross-process gather on it.  With ``transfer_dtype`` set only
        the wide segment (phi + interactions) takes the reduced dtype."""

        engine = self.engine
        X, B = self._pad_sharded(X)
        with capture_kernel_paths() as kp:
            out = fn(X, *args)
        engine._note_kernel_paths(kp)  # kernel_path proxies via __getattr__
        has_inter = 'interaction_values' in out
        td = engine.config.shap.transfer_dtype
        packed = {}
        for s, phi in enumerate(out['shap_values']):
            if phi is None:
                continue  # a data shard another process holds
            wide = [phi.reshape(-1)]
            if has_inter:
                wide.append(out['interaction_values'][s].reshape(-1))
            p = pack_transfer(torch.cat(wide), out['raw_prediction'][s].reshape(-1), td)
            packed[s] = (p, _stream_of(p))
        return packed, B, X.shape[0], has_inter, replicated

    def _dispatch_sharded(self, X: np.ndarray, nsamples):
        plan = self.engine._plan(nsamples)
        return self._dispatch_call(self._sharded_fn(), X, self._device_args(plan),
                                   replicated=self.replicate_results)

    def _fetch_sharded(self, dispatched):
        """Copy one dispatched call's results to the host, one copy per
        packed tensor, and return ``(shap_values, link-space raw
        predictions)`` in row order, plus the ``(B, K, M, M)`` interaction
        tensor when the dispatched function produced one.  Under several
        processes a data-sharded result is first gathered from every
        process (the reference's ``process_allgather(tiled=True)``): a
        collective, so every process fetches in the same order."""

        from distributedkernelshap_tpu_torch.kernel_shap import _on_stream

        packed, B, Bp, has_inter, replicated = dispatched
        engine = self.engine
        K, M = engine.predictor.n_outputs, engine.M
        td = engine.config.shap.transfer_dtype
        n_slots = 1 if replicated else self.n_data
        if self.mesh.multiprocess and not replicated:
            host = {}
            for s, (p, stream) in packed.items():
                with _on_stream(stream):
                    host[(s,)] = p.cpu()
            got = exchange(host)
            packed = {s: (got[(s,)], None) for s in range(n_slots)}
        rows = Bp // n_slots
        n_phi = rows * K * M
        n_wide = n_phi + (rows * K * M * M if has_inter else 0)
        phis, fxs, inters = [], [], []
        for s in range(n_slots):
            p, stream = packed[s]
            with _on_stream(stream):
                flat = fetch_transfer(p)
            wide, fx = unpack_transfer(flat, n_wide, td)
            phis.append(wide[:n_phi].reshape(rows, K, M))
            fxs.append(fx.reshape(rows, K))
            if has_inter:
                inters.append(wide[n_phi:].reshape(rows, K, M, M))
        out = [np.concatenate(phis)[:B], np.concatenate(fxs)[:B]]
        if has_inter:
            out.append(np.concatenate(inters)[:B])
        return tuple(out)

    def _explain_sharded(self, X: np.ndarray, nsamples) -> Tuple[np.ndarray, np.ndarray]:
        """One sharded call over the global batch ``X``; returns
        ``(shap_values, link-space raw predictions)``."""

        return self._fetch_sharded(self._dispatch_sharded(X, nsamples))

    # ------------------------------------------------------------------ #
    # exact paths: the background axis over ``coalition``

    def _replicas(self) -> PredictorReplicas:
        if 'replicas' not in self._fn_cache:
            self._fn_cache['replicas'] = PredictorReplicas(self.engine.predictor)
        return self._fn_cache['replicas']

    def _column_devices(self, j: int) -> List[torch.device]:
        """The distinct devices of coalition column ``j`` this process owns."""

        out: List[torch.device] = []
        for i in range(self.n_data):
            d = self.mesh.device(i, j)
            if self.mesh.is_local(i, j) and d not in out:
                out.append(d)
        return out

    def _normalised_bgw(self) -> torch.Tensor:
        """The background weights normalised over the WHOLE background, in
        float64 then float32 (the exact wrappers take normalised weights, so
        a shard's slice must carry the global normalisation)."""

        bgw0 = np.asarray(self.engine.bg_weights, np.float64)
        return torch.as_tensor((bgw0 / bgw0.sum()).astype(np.float32))

    def _exact_sharded_fn(self, interactions: bool = False):
        """Closed-form interventional TreeSHAP (``ops/treeshap.py``) over
        the 2-D mesh (reference ``distributed.py:408-525``): instances over
        ``data``, the background over ``coalition`` — each shard computes
        partial phi over its background slice (globally-normalised weights,
        padded to a whole number of shards with zero-weight rows by
        :func:`~distributedkernelshap_tpu_torch.ops.treeshap.pad_background`)
        and the group's partials add up on its first device.

        ``interactions`` adds the exact interaction matrices: every term of
        the local matrix (off-diagonals AND the diagonal's ``phi - row-sum``
        residual) is linear in the background contributions, so the sum of
        the shards' matrices IS the global matrix.  Returns ``(fn, ())``."""

        key = ('exact', interactions)
        if key in self._fn_cache:
            return self._fn_cache[key]
        from distributedkernelshap_tpu_torch.ops.treeshap import (
            background_reach,
            build_packed_plan,
            exact_shap_and_interactions,
            exact_shap_from_reach,
            pad_background,
            resolve_pack_paths,
        )

        engine = self.engine
        shap = engine.config.shap
        use_kernel = shap.use_kernel
        budget = shap.target_chunk_elems
        n_coal = self.mesh.shape[COALITION_AXIS]
        if not interactions:
            # packed work-item sharding: the planner stripes its
            # depth-bucketed tiles over the coalition axis (identical local
            # bucket structure on every shard); the background split below
            # serves the dense layout and the interactions
            plan = build_packed_plan(engine.predictor, engine.G, shards=n_coal)
            if resolve_pack_paths(shap.pack_paths, plan):
                self._fn_cache[key] = (self._exact_packed_sharded_fn(plan), ())
                return self._fn_cache[key]
        if 'exact_reach' not in self._fn_cache:
            # reach tensors + padded weights depend only on (background, G,
            # mesh): shared by both dense variants
            with torch.no_grad():
                reach = background_reach(
                    engine.predictor, torch.as_tensor(engine.background, device=engine.device),
                    torch.as_tensor(engine.G, device=engine.device),
                    target_chunk_elems=budget)
            z_ok, z_ung, bgw = pad_background(
                reach['z_ok'], reach['z_ung_dead'],
                self._normalised_bgw().to(engine.device), n_coal)
            n_loc = z_ok.shape[0] // n_coal
            cols = []
            for j in range(n_coal):
                sl = slice(j * n_loc, (j + 1) * n_loc)
                devs = self._column_devices(j)
                cols.append({
                    'z_ok': replicate(z_ok[sl].contiguous(), devs),
                    'z_ung_dead': replicate(z_ung[sl].contiguous(), devs),
                    'bgw': replicate(bgw[sl].contiguous(), devs)})
            distinct = self.mesh.distinct_devices
            self._fn_cache['exact_reach'] = (
                cols, replicate(reach['onpath_g'], distinct),
                replicate(torch.as_tensor(engine.G), distinct))
        cols, onpath_g, G = self._fn_cache['exact_reach']
        replicas = self._replicas()
        mesh, n_data = self.mesh, self.n_data

        @torch.no_grad()
        def fn(X):
            rows = split_rows(torch.as_tensor(np.asarray(X, np.float32)), n_data)
            parts = {}
            for i, j in mesh.local_entries():
                dev = mesh.device(i, j)
                r = {'z_ok': cols[j]['z_ok'].on(dev),
                     'z_ung_dead': cols[j]['z_ung_dead'].on(dev),
                     'onpath_g': onpath_g.on(dev)}
                args = (replicas.on(dev), rows[i].to(dev), r, cols[j]['bgw'].on(dev),
                        G.on(dev))
                kw = dict(normalized=True, target_chunk_elems=budget,
                          use_kernel=use_kernel)
                if interactions:
                    phi_l, inter_l = exact_shap_and_interactions(*args, **kw)
                    parts[(i, j)] = {'phi': phi_l, 'inter': inter_l}
                else:
                    parts[(i, j)] = {'phi': exact_shap_from_reach(*args, **kw)}
            phis, fxs, inters = [None] * n_data, [None] * n_data, [None] * n_data
            for i, group in mesh.group_parts(parts).items():
                phis[i] = _sum_in_order(group, 'phi', mesh.device(i, 0))
                if interactions:
                    inters[i] = _sum_in_order(group, 'inter', mesh.device(i, 0))
                fxs[i] = _lead_predict(replicas, mesh, rows, i)
            out = {'shap_values': phis, 'raw_prediction': fxs}
            if interactions:
                out['interaction_values'] = inters
            return out

        self._fn_cache[key] = (fn, ())
        return self._fn_cache[key]

    def _exact_packed_sharded_fn(self, plan):
        """Packed-work-item sharded exact phi (reference
        ``distributed.py:527-603``): path tiles striped over the coalition
        axis (``ops/treeshap_pack.py`` with ``shards=n_coal``), the instance
        axis over ``data``.  Each shard holds only its slice of the packed
        reach tensors, runs one ``exact_tree_phi`` per local depth bucket
        against the full background, and the group's partial phi add up on
        its first device."""

        from distributedkernelshap_tpu_torch.ops.treeshap import (
            background_reach,
            exact_shap_packed,
            pack_reach,
        )

        engine = self.engine
        shap = engine.config.shap
        use_kernel = shap.use_kernel
        budget = shap.target_chunk_elems
        buckets = plan.buckets                  # LOCAL per-shard structure
        n_coal = self.mesh.shape[COALITION_AXIS]
        with torch.no_grad():
            reach = background_reach(
                engine.predictor, torch.as_tensor(engine.background, device=engine.device),
                torch.as_tensor(engine.G, device=engine.device), target_chunk_elems=budget)
            packed = pack_reach(engine.predictor, reach, plan)
        L = plan.local_len
        cols = []
        for j in range(n_coal):
            sl = slice(j * L, (j + 1) * L)
            devs = self._column_devices(j)
            cols.append({
                'z_ok': replicate(packed['z_ok'][:, sl].contiguous(), devs),
                'z_dead': replicate(packed['z_dead'][:, sl].contiguous(), devs),
                'lv': replicate(packed['lv'][sl].contiguous(), devs),
                'perm': replicate(packed['perm'][sl].contiguous(), devs),
                'live': replicate(packed['live'][sl].contiguous(), devs)})
        distinct = self.mesh.distinct_devices
        onpath_g = replicate(reach['onpath_g'], distinct)
        G = replicate(torch.as_tensor(engine.G), distinct)
        bgw = replicate(self._normalised_bgw(), distinct)
        replicas = self._replicas()
        mesh, n_data = self.mesh, self.n_data

        @torch.no_grad()
        def fn(X):
            rows = split_rows(torch.as_tensor(np.asarray(X, np.float32)), n_data)
            parts = {}
            for i, j in mesh.local_entries():
                dev = mesh.device(i, j)
                packed_l = {k: v.on(dev) for k, v in cols[j].items()}
                parts[(i, j)] = {'phi': exact_shap_packed(
                    replicas.on(dev), rows[i].to(dev), onpath_g.on(dev), packed_l,
                    bgw.on(dev), G.on(dev), buckets, normalized=True,
                    target_chunk_elems=budget, use_kernel=use_kernel)}
            phis, fxs = [None] * n_data, [None] * n_data
            for i, group in mesh.group_parts(parts).items():
                phis[i] = _sum_in_order(group, 'phi', mesh.device(i, 0))
                fxs[i] = _lead_predict(replicas, mesh, rows, i)
            return {'shap_values': phis, 'raw_prediction': fxs}

        return fn

    def _exact_tn_sharded_fn(self):
        """Exact tensor-network Shapley over the 2-D mesh (reference
        ``distributed.py:605-675``): instances over ``data``, the
        background rows over ``coalition``.  Each shard runs the size-indexed
        DP over ITS background slice; the per-row phi contributions are
        gathered on the group's first device and the weighted row sum runs
        there in the single-device formulation.  The background pads to a
        whole number of shards with zero-weight rows.  Returns
        ``(fn, ())``."""

        key = 'exact_tn'
        if key in self._fn_cache:
            return self._fn_cache[key]
        from distributedkernelshap_tpu_torch.ops.tensor_shap import (
            tn_phi_rows,
            weight_toeplitz,
        )

        engine = self.engine
        budget = engine.config.shap.target_chunk_elems
        n_coal = self.mesh.shape[COALITION_AXIS]
        struct = engine.predictor.tt_structure()
        bg = np.asarray(engine.background, np.float32)
        bgw0 = self._normalised_bgw().numpy()
        pad = (-bg.shape[0]) % n_coal
        if pad:
            bg = np.concatenate([bg, np.tile(bg[-1:], (pad, 1))], 0)
            bgw0 = np.concatenate([bgw0, np.zeros(pad, np.float32)], 0)
        n_loc = bg.shape[0] // n_coal
        bg_cols = [replicate(torch.as_tensor(bg[j * n_loc:(j + 1) * n_loc]),
                             self._column_devices(j)) for j in range(n_coal)]
        distinct = self.mesh.distinct_devices
        consts = {name: replicate(t, distinct) for name, t in (
            ('A', struct['A']), ('B', struct['B']), ('head', struct['head']),
            ('Wt', torch.as_tensor(weight_toeplitz(engine.M))),
            ('bgw', torch.as_tensor(bgw0)))}
        replicas = self._replicas()
        mesh, n_data = self.mesh, self.n_data

        @torch.no_grad()
        def fn(X):
            rows = split_rows(torch.as_tensor(np.asarray(X, np.float32)), n_data)
            parts = {}
            for i, j in mesh.local_entries():
                dev = mesh.device(i, j)
                parts[(i, j)] = {'rows': tn_phi_rows(
                    consts['A'].on(dev), consts['B'].on(dev), consts['head'].on(dev),
                    consts['Wt'].on(dev), rows[i].to(dev), bg_cols[j].on(dev),
                    target_chunk_elems=budget)}
            phis, fxs = [None] * n_data, [None] * n_data
            for i, group in mesh.group_parts(parts).items():
                d0 = mesh.device(i, 0)
                with full_f32_matmul():
                    phis[i] = torch.einsum('n,nbkm->bkm', consts['bgw'].on(d0),
                                           torch.cat([g['rows'].to(d0) for g in group]))
                fxs[i] = _lead_predict(replicas, mesh, rows, i)
            return {'shap_values': phis, 'raw_prediction': fxs}

        self._fn_cache[key] = (fn, ())
        return self._fn_cache[key]

    def _split_slabs(self, X: np.ndarray):
        """``(slabs, B)``: a batch over one slab padded to a whole number of
        equal slabs of :meth:`_slab_size` rows (one shape for every device
        step; ``batch_size`` bounds the rows a device holds, on every
        path), else the batch as one slab — padding it up to a slab would
        multiply the work by up to ``n_data`` for nothing."""

        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        B = X.shape[0]
        if not self._needs_slabs(B):
            return [X], B
        slab = self._slab_size()
        padded, _ = pad_to_multiple(B, slab)
        if padded != B:
            X = np.concatenate([X, np.tile(X[-1:], (padded - B, 1))], 0)
        return make_batches(X, batch_size=slab), B

    def _explain_exact_tn_sharded(self, X: np.ndarray, l1_reg,
                                  interactions: bool = False) -> Any:
        from distributedkernelshap_tpu_torch.kernel_shap import _fingerprint
        from distributedkernelshap_tpu_torch.ops.tensor_shap import validate_exact_tn

        engine = self.engine
        validate_exact_tn(engine.predictor, engine.config.link, engine.G)
        if interactions:
            raise ValueError(
                "interactions=True requires a lifted tree ensemble; the "
                "tensor-network exact path computes phi only.")
        if l1_reg not in (None, False, 0, 'auto'):
            logger.warning("l1_reg=%r is ignored with nsamples='exact'.", l1_reg)

        slabs, B = self._split_slabs(X)
        fn, args = self._exact_tn_sharded_fn()
        journal = self._journal_for(slabs, 'exact_tn', 'exact', interactions=False)
        results = self._run_slabs(
            slabs, lambda s: self._dispatch_call(fn, s, args), journal=journal)

        phi = np.concatenate([r[0] for r in results], 0)[:B]
        self.last_raw_prediction = np.concatenate([r[1] for r in results], 0)[:B]
        self.last_interaction_values = None
        self.last_X_fingerprint = _fingerprint(np.atleast_2d(np.asarray(X, np.float32)))
        return split_shap_values(phi, engine.vector_out)

    def _explain_exact_sharded(self, X: np.ndarray, l1_reg,
                               interactions: bool = False) -> Any:
        from distributedkernelshap_tpu_torch.kernel_shap import _fingerprint
        from distributedkernelshap_tpu_torch.ops.tensor_shap import supports_exact_tn
        from distributedkernelshap_tpu_torch.ops.treeshap import (
            supports_exact,
            validate_exact,
        )

        engine = self.engine
        if not supports_exact(engine.predictor) and supports_exact_tn(engine.predictor):
            return self._explain_exact_tn_sharded(X, l1_reg, interactions)
        validate_exact(engine.predictor, engine.config.link)
        if l1_reg not in (None, False, 0, 'auto'):
            logger.warning("l1_reg=%r is ignored with nsamples='exact'.", l1_reg)

        slabs, B = self._split_slabs(X)
        fn, args = self._exact_sharded_fn(interactions=interactions)
        journal = self._journal_for(slabs, 'exact', 'exact', interactions=interactions)
        results = self._run_slabs(
            slabs, lambda s: self._dispatch_call(fn, s, args), journal=journal)

        phi = np.concatenate([r[0] for r in results], 0)[:B]
        self.last_raw_prediction = np.concatenate([r[1] for r in results], 0)[:B]
        if interactions:
            inter = np.concatenate([r[2] for r in results], 0)[:B]
            self.last_interaction_values = [inter[:, k] for k in range(inter.shape[1])]
        self.last_X_fingerprint = _fingerprint(np.atleast_2d(np.asarray(X, np.float32)))
        return split_shap_values(phi, engine.vector_out)

    # ------------------------------------------------------------------ #
    # slabs and the journal

    def _journal_for(self, slabs, kind: str, nsamples,
                     interactions: bool = False):
        """A :class:`ShardJournal` for this run, or ``None`` with
        checkpointing off (reference ``distributed.py:773-823``).  The run
        key covers everything that determines a slab's bytes — model
        fingerprint, the exact (padded) input, the shard layout and the
        explain options — so any change produces a different journal file,
        never a partially reused one."""

        if not self.checkpoint_dir:
            return None
        if self.mesh.multiprocess:
            # each process journals locally, so two processes could restore
            # DIFFERENT slab subsets and desync the collective order of the
            # sharded fetches: a hang, not a resume.  Warn and degrade
            logger.warning("checkpoint_dir is single-process only; "
                           "ignoring it on this multi-process mesh")
            return None
        from distributedkernelshap_tpu_torch.resilience.journal import (
            ShardJournal,
            journal_fingerprint,
            run_journal_path,
        )
        from distributedkernelshap_tpu_torch.scheduling.result_cache import (
            array_fingerprint,
        )

        fp = self._pinned_journal_fp or journal_fingerprint(self.engine)
        slab_digest = hashlib.sha256()
        for s in slabs:
            slab_digest.update(array_fingerprint(s).encode())
        meta = {
            "fingerprint": fp,
            "input": slab_digest.hexdigest(),
            "n_shards": len(slabs),
            "kind": kind,
            "nsamples": repr(nsamples),
            "interactions": bool(interactions),
            "transfer_dtype": repr(self.engine.config.shap.transfer_dtype),
            "mesh": [int(self.n_data), int(self.coalition_parallel)],
        }
        run_digest = hashlib.sha256(
            json.dumps(meta, sort_keys=True).encode()).hexdigest()
        path = run_journal_path(self.checkpoint_dir, fp, run_digest)
        return ShardJournal(path, meta)

    def _run_slabs(self, slabs, dispatch, fetch_is_local: bool = False, journal=None):
        """Run the slab sequence through the shared bounded pipeline
        (``parallel/pipeline.py``): window resolved from the
        ``dispatch_window`` opt, else ``EngineConfig.dispatch_window``, else
        the env / a round-trip probe (under several processes rank 0's
        window, broadcast); fetches threaded so their copies overlap,
        except on a multi-process mesh whose fetches carry collectives,
        which stay serial and in the same order on every process.
        ``fetch_is_local`` is per call site: the sampled path under
        ``replicate_results`` fetches locally, the exact paths never do."""

        from distributedkernelshap_tpu_torch.parallel.pipeline import (
            resolve_window,
            run_pipeline,
        )

        requested = (self.dispatch_window
                     if self.dispatch_window is not None
                     else self.engine.config.dispatch_window)
        window = resolve_window(requested, n_items=len(slabs), device=self.engine.device)
        try:
            return run_pipeline(slabs, dispatch, self._fetch_sharded, window=window,
                                threaded=(not self.mesh.multiprocess) or fetch_is_local,
                                journal=journal)
        finally:
            if journal is not None:
                self.last_journal_stats = journal.stats()
                journal.close()
            else:
                # a non-journaled run must not leave a previous journaled
                # run's stats behind (the attribute contract is "this run")
                self.last_journal_stats = None

    def _slab_size(self) -> int:
        """Rows per sharded slab (``batch_size`` instances per data shard),
        or 0 when slabbing is off — ONE implementation for every path that
        must agree on when a batch splits."""

        return int(self.batch_size) * self.n_data if self.batch_size else 0

    def _needs_slabs(self, B: int) -> bool:
        slab = self._slab_size()
        return bool(slab) and B > slab

    # ------------------------------------------------------------------ #

    def get_importance(self, X: np.ndarray, nsamples=None) -> np.ndarray:
        """``(K, M)`` mean |phi| over ``X`` with the reduction on the mesh
        (reference ``distributed.py:875-921``): each slab's phi is
        abs-summed on its shard's device and the partials are added on the
        mesh's first device, so only ``K·M`` floats reach the host."""

        engine = self.engine
        if engine.config.host_eval or nsamples == 'exact':
            values = self.get_explanation(X, nsamples=nsamples,
                                          l1_reg=False, silent=True)
            vals = values if isinstance(values, list) else [values]
            return np.stack([np.abs(v).mean(0) for v in vals])
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        B = X.shape[0]
        slabs = (make_batches(X, batch_size=self._slab_size())
                 if self._needs_slabs(B) else [X])
        plan = engine._plan(nsamples)
        args = self._device_args(plan)
        fn = self._sharded_fn()
        d00 = self.mesh.first_local_device()
        acc = None
        with capture_kernel_paths() as kp:
            for c in slabs:
                Xc, Bc = self._pad_sharded(c)
                out = fn(Xc, *args)
                rows = Xc.shape[0] // len(out['shap_values'])
                parts = {}
                for s, phi in enumerate(out['shap_values']):
                    if phi is None:
                        continue  # a data shard another process holds
                    # mask the padded rows out instead of slicing them off
                    w = (torch.arange(s * rows, (s + 1) * rows, device=phi.device)
                         < Bc).to(phi.dtype)
                    parts[(s,)] = torch.einsum('bkm,b->km', phi.abs(), w)
                if self.mesh.multiprocess and not self.replicate_results:
                    # every process adds every shard's (K, M) partial, in
                    # shard order: the same bits everywhere
                    parts = exchange(parts)
                for key in sorted(parts):
                    part = parts[key].to(d00)
                    acc = part if acc is None else acc + part
        engine._note_kernel_paths(kp)
        return acc.cpu().numpy() / B

    def takes_async_fast_path(self, n_rows: int, nsamples=None,
                              l1_reg='auto',
                              interactions: bool = False) -> bool:
        """Whether :meth:`get_explanation_async` would truly pipeline for a
        batch of ``n_rows`` with these options, vs computing synchronously
        in the fallback closure (reference ``distributed.py:923-936``)."""

        return not ((self.mesh.multiprocess and not self.replicate_results)
                    or interactions or nsamples == 'exact'
                    or self._needs_slabs(int(n_rows))
                    or self.engine._l1_active(l1_reg, nsamples))

    def get_explanation_async(self, X: np.ndarray,
                              nsamples: Union[str, int, None] = None,
                              l1_reg: Union[str, float, int, None] = 'auto',
                              interactions: bool = False):
        """Asynchronous variant of :meth:`get_explanation` for the serving
        pipeline: issues the sharded device work now and returns
        ``finalize() -> (values, info)`` — the same contract as
        ``KernelExplainerEngine.get_explanation_async``.  A multi-process
        mesh pipelines only with ``replicate_results`` (the gather runs at
        dispatch, so the finalize is a local copy any thread may make);
        without it, and for the exact path, slab-split batches and active l1
        selection, it falls back to a synchronous closure, mirroring the
        engine's fallback matrix."""

        # a StagedRows could only arrive through a caller bypassing
        # stage_rows (which declines for sharded explainers); consume its
        # host rows rather than failing opaquely
        X = getattr(X, 'host', X)
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        if not self.takes_async_fast_path(X.shape[0], nsamples=nsamples,
                                          l1_reg=l1_reg,
                                          interactions=interactions):
            from distributedkernelshap_tpu_torch.kernel_shap import (
                _async_sync_fallback,
            )

            return _async_sync_fallback(self, X, nsamples, l1_reg, interactions)

        dispatched = self._dispatch_sharded(X, nsamples)
        e_val = np.atleast_1d(np.asarray(self.engine.expected_value,
                                         dtype=np.float32))

        def finalize():
            phi, fx = self._fetch_sharded(dispatched)
            # pure numpy from here (l1 inactive, checked above); shared
            # state (last_*) is deliberately not written — finalize may run
            # on any server thread
            return split_shap_values(phi, self.engine.vector_out), {
                'raw_prediction': fx,
                'expected_value': e_val,
            }

        return finalize

    def get_explanation(self, X: np.ndarray, **kwargs) -> Any:
        """Explain ``X``, sharded over the mesh (reference
        ``distributed.py:989-1048``).

        ``batch_size`` (reference semantics: minibatch per worker) maps to
        per-device sub-batches: the global array is processed in slabs of
        ``batch_size * n_data`` rows so each data shard sees ``batch_size``
        instances per step.  Results need no reordering."""

        from distributedkernelshap_tpu_torch.kernel_shap import _fingerprint

        nsamples = kwargs.pop('nsamples', None)
        kwargs.pop('silent', None)
        l1_reg = kwargs.pop('l1_reg', 'auto')
        interactions = kwargs.pop('interactions', False)
        if interactions and nsamples != 'exact':
            raise ValueError(
                "interactions=True requires nsamples='exact' (closed-form "
                "interventional TreeSHAP); the sampled KernelSHAP estimator "
                "does not produce interaction values.")
        if not interactions:
            # never let interaction tensors from an earlier explain pair
            # with this call's fingerprint/raw predictions
            self.last_interaction_values = None

        if nsamples == 'exact':
            return self._explain_exact_sharded(X, l1_reg, interactions=interactions)

        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        slabs, B = self._split_slabs(X)
        # dispatch ahead of fetch: later slabs' device work is queued while
        # earlier slabs' copies are in flight; the window bounds how many
        # slabs are on the devices at once
        journal = self._journal_for(slabs, 'sampled', nsamples)
        results = self._run_slabs(
            slabs, lambda s: self._dispatch_sharded(s, nsamples),
            fetch_is_local=self.replicate_results, journal=journal)
        phi = np.concatenate([r[0] for r in results], 0)[:B]
        self.last_raw_prediction = np.concatenate([r[1] for r in results], 0)[:B]
        self.last_X_fingerprint = _fingerprint(X)

        phi = self.engine._apply_l1_reg(phi, X, l1_reg, nsamples)
        return split_shap_values(phi, self.engine.vector_out)
