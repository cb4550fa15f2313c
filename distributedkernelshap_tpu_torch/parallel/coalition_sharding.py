"""Coalition-axis sharding: several devices co-operating on one explanation.

Port of ``distributedkernelshap_tpu/parallel/coalition_sharding.py``.  The
``nsamples`` coalition rows of one explanation split across the devices of
a data-parallel group: each device evaluates its slice of the synthetic
data and accumulates *partial normal equations* ``A_part = Zt'·W·Zt`` and
``rhs_part`` — plain sums over coalition rows — which add up exactly to the
single-device system.  The reference adds them with one ``psum`` over the
coalition axis; here the group's partials are copied to its first device
and summed there in shard order, and that device solves.  Under several
processes each process runs only the shards it owns; a group whose shards
belong to several processes gathers them with ``mesh.exchange`` (every
rank receives the same bytes), so the sum is the one-process mesh's, bit
for bit.

Each shard runs the single-device kernel stack on its local shapes: the
linear route launches ``fused_linear_ey`` (``ops/cuda_kernels.py``) once per
shard on a CUDA device, other predictors take their ``masked_ey`` or the
row-materialising route.  The background is never split on this path, so
the kernel's own normalisation of the background weights is the global
one.
"""

from typing import Dict, List

import numpy as np
import torch

from distributedkernelshap_tpu_torch.models.predictors import BasePredictor
from distributedkernelshap_tpu_torch.ops.explain import (
    ShapConfig,
    _auto_chunk,
    _ey_generic,
    _ey_linear,
    _use_masked_ey,
    normal_equations,
    record_kernel_path,
    resolve_use_kernel,
    solve_from_normal,
)
from distributedkernelshap_tpu_torch.ops.links import convert_to_link
from distributedkernelshap_tpu_torch.parallel.mesh import (
    COALITION_AXIS,
    DATA_AXIS,
    DeviceMesh,
    PredictorReplicas,
    exchange,
)


def pad_coalitions(mask: torch.Tensor, weights: torch.Tensor, multiple: int):
    """Pad the coalition rows to a whole number of ``multiple``-row shards
    with zero-weight rows (reference ``coalition_sharding.py:147-151``):
    they contribute nothing to the normal equations."""

    pad = (-mask.shape[0]) % multiple
    if not pad:
        return mask, weights
    return (torch.cat([mask, mask.new_zeros((pad, mask.shape[1]))], 0),
            torch.cat([weights, weights.new_zeros((pad,))], 0))


def split_rows(X, n_data: int) -> List:
    """``X`` cut into ``n_data`` equal row blocks (``X``'s rows are a
    multiple of ``n_data``: the caller pads)."""

    B = X.shape[0]
    if B % n_data:
        raise ValueError(f"{B} rows do not split over {n_data} data shards")
    step = B // n_data
    return [X[i * step:(i + 1) * step] for i in range(n_data)]


def gather_results(mesh: DeviceMesh, per_group: List) -> List[torch.Tensor]:
    """The data groups' results (``per_group[i]`` on group ``i``'s first
    device where this process leads it, else ``None``) as ONE tensor on
    this process's first device, rows in order: the reference's
    ``replicate_results`` gather.  Under several processes every rank
    receives every group's result through ``mesh.exchange`` (a collective,
    issued here at dispatch, so the later fetch is local)."""

    d00 = mesh.first_local_device()
    if mesh.multiprocess:
        got = exchange({(i,): t for i, t in enumerate(per_group) if t is not None})
        per_group = [got[(i,)] for i in range(len(per_group))]
    return [torch.cat([t.to(d00) for t in per_group])]


def build_coalition_sharded_fn(predictor: BasePredictor,
                               config: ShapConfig,
                               mesh: DeviceMesh,
                               replicate_results: bool = False):
    """Build the 2-D-sharded explain function over ``mesh`` (data,
    coalition) (reference ``coalition_sharding.py:40-162``).

    Returns ``explain(X, bg, bgw, mask, weights, G) -> dict``: ``X`` the
    global batch (host array or tensor, rows a multiple of the data axis),
    the constants :class:`~distributedkernelshap_tpu_torch.parallel.mesh.
    PerDevice` copies on the mesh's devices, the coalition rows already
    padded to a multiple of the coalition axis (:func:`pad_coalitions`).
    The outputs are the single-device function's, with ``shap_values`` and
    ``raw_prediction`` a list of one tensor per data shard, in row order,
    each on its group's first device (``None`` for a group another process
    leads); ``expected_value`` is one tensor (``None`` where this process
    owns no shard).  ``replicate_results=True`` gathers them into one
    tensor on this process's first device (a one-element list) on every
    process: the host then makes one local copy."""

    link_fn = convert_to_link(config.link)
    linear = predictor.linear_decomposition
    n_data = mesh.shape[DATA_AXIS]
    n_coal = mesh.shape[COALITION_AXIS]
    replicas = PredictorReplicas(predictor)

    def local_ey(pred, X, bg, bgw_n, mask_local, G):
        """Expected outputs for this shard's coalition rows."""

        B, D = X.shape
        N = bg.shape[0]
        K = pred.n_outputs
        S_local = mask_local.shape[0]
        if linear is not None:
            W, b, activation = pred.linear_decomposition
            chunk = config.coalition_chunk or _auto_chunk(S_local, B * N * K,
                                                          config.target_chunk_elems)
            return _ey_linear(W, b, activation, X, bg, bgw_n, mask_local, G, chunk,
                              use_kernel=resolve_use_kernel(config.use_kernel, X.device))
        if _use_masked_ey(pred, B, N, S_local, mask_local.shape[1], config):
            # per-shard coalition rows through the structure-aware fast path
            ey = pred.masked_ey(X, bg, bgw_n, mask_local, G,
                                config.target_chunk_elems,
                                coalition_chunk=config.coalition_chunk)
            record_kernel_path("ey", "masked_ey")
            return ey
        record_kernel_path("ey", "generic")
        zc_local = mask_local @ G
        chunk = config.coalition_chunk or _auto_chunk(S_local, B * N * D,
                                                      config.target_chunk_elems)
        return _ey_generic(pred, X, bg, bgw_n, zc_local, chunk)

    def shard_body(pred, X, bg, bgw, mask_local, w_local, G) -> Dict:
        """One (data, coalition) shard: ``X`` this data shard's rows,
        ``mask_local``/``w_local`` this coalition shard's rows, on one
        device."""

        bgw_n = bgw / bgw.sum()
        ey = local_ey(pred, X, bg, bgw_n, mask_local, G)    # (B_loc, S_loc, K)
        fx = link_fn(pred(X))                               # (B_loc, K)
        e_out = torch.einsum("nk,n->k", pred(bg), bgw_n)
        expected_value = link_fn(e_out)
        ey_adj = link_fn(ey) - expected_value[None, None, :]
        fx_minus_e = fx - expected_value[None, :]
        out = {"fx": fx, "fx_minus_e": fx_minus_e, "expected_value": expected_value}
        if mask_local.shape[1] > 1:
            out["A"], out["rhs"] = normal_equations(mask_local, w_local, ey_adj,
                                                    fx_minus_e)
        return out

    @torch.no_grad()
    def explain(X, bg, bgw, mask, weights, G):
        rows = split_rows(torch.as_tensor(np.asarray(X, dtype=np.float32)), n_data)
        S = next(iter(mask.values())).shape[0]
        if S % n_coal:
            raise ValueError(f"{S} coalition rows do not split over {n_coal} "
                             "coalition shards: pad them with pad_coalitions")
        s_loc = S // n_coal
        parts = {}
        for i, j in mesh.local_entries():
            dev = mesh.device(i, j)
            sl = slice(j * s_loc, (j + 1) * s_loc)
            out = shard_body(
                replicas.on(dev), rows[i].to(dev), bg.on(dev), bgw.on(dev),
                mask.on(dev)[sl], weights.on(dev)[sl], G.on(dev))
            # a coalition shard past the first contributes its partial sums only
            parts[(i, j)] = out if j == 0 else {k: out[k] for k in ("A", "rhs") if k in out}
        phis: List = [None] * n_data
        fxs: List = [None] * n_data
        expected_value = None
        for i, group in mesh.group_parts(parts).items():
            first = group[0]
            if expected_value is None:
                expected_value = first["expected_value"]
            if "A" not in first:
                phi = first["fx_minus_e"][:, :, None]
            else:
                # the reference's psum over the coalition axis: the group's
                # partial sums added on its first device, in shard order
                d0 = mesh.device(i, 0)
                A = first["A"]
                rhs = first["rhs"]
                for p in group[1:]:
                    A = A + p["A"].to(d0)
                    rhs = rhs + p["rhs"].to(d0)
                phi = solve_from_normal(A, rhs, first["fx_minus_e"], config.ridge)
            phis[i] = phi
            fxs[i] = first["fx"]
        if replicate_results:
            phis, fxs = gather_results(mesh, phis), gather_results(mesh, fxs)
        return {"shap_values": phis, "expected_value": expected_value,
                "raw_prediction": fxs}

    explain.replicas = replicas
    return explain

