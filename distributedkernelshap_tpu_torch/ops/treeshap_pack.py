"""Path-parallel work scheduling for exact TreeSHAP (host-side planner).

A copy of ``distributedkernelshap_tpu/ops/treeshap_pack.py`` (numpy only;
the port keeps its own so it never imports the JAX package).  Its plans
are held equal to the JAX package's with ``array_equal``.

The exact pipeline's unit of work is one (instance-tile, leaf-path) pair:
every leaf-path contributes independently to phi, and the per-path cost is
proportional to the number of feature groups on its root path (the
conjunction-game count bound ``u + v``).  The legacy layout processes the
DENSE ``(T, L)`` path grid: padded leaf slots (unbalanced ensembles never
fill ``L_max`` leaves in every tree) ride every contraction as dead work,
and the fused kernel's binomial-weight loop runs ``dmax_global`` steps for
EVERY tile because a single deep leaf raises the static bound for the
whole ensemble.  GPUTreeShap (arXiv:2010.13972) solves the same imbalance
on CUDA with one work item per (instance, path) and load-balanced bin
packing; this module is the TPU-shaped counterpart:

* enumerate the LIVE paths (real leaves whose path touches >= 1 relevant
  group — zero-group paths have identically-zero phi contribution and are
  dropped);
* sort them by group count and split into **depth buckets** whose members
  are within 2x of the bucket's max (so the per-bucket static ``dmax``
  wastes < 2x loop steps on any member);
* pack each bucket into ``tile``-path grid tiles, striped round-robin
  across ``shards`` mesh ranks so every rank carries the SAME bucket
  structure (shard_map is SPMD: the static program must match) with
  balanced total work.

The planner runs on host numpy from the predictor's concrete per-fit path
tensors — it is X-independent, so the engine computes it once per
(model, grouping) and caches the packed device tensors beside it (the
same contract as the linear path's plan-constant cache).
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

#: auto-enable threshold for `ops.treeshap` dispatch: packing engages when
#: the modelled dense/packed work ratio clears this (below it, the dense
#: layout is kept).  The Adult GBT (50 trees) plans a gain of 1.40 and packs.
PACK_AUTO_GAIN = 1.25

#: default paths per grid tile (matches the fused kernel's default `tp`)
DEFAULT_TILE = 256


def leaf_group_counts(path_sign, feature, G) -> np.ndarray:
    """Per-leaf count of RELEVANT feature groups on the root path.

    ``path_sign (T, L, Nn)`` / ``feature (T, Nn)`` are the predictor's
    concrete path tensors, ``G (M, D)`` the 0/1 group matrix.  Returns an
    ``(T, L)`` int array: the conjunction-game count bound ``u + v`` for
    each leaf, ``0`` for paths touching no grouped column (their phi
    contribution is identically zero) and ``-1`` for padded dead slots
    (no on-path nodes).
    """

    onpath = np.abs(np.asarray(path_sign, np.float32))        # (T, L, Nn)
    GH = np.asarray(G, np.float32).T[np.asarray(feature)]     # (T, Nn, M)
    cnt = (np.einsum("tlj,tjm->tlm", onpath, GH) > 0.5).sum(-1)
    dead = onpath.sum(-1) <= 0.5
    return np.where(dead, -1, cnt).astype(np.int64)


@dataclass(frozen=True)
class PackedPathPlan:
    """A bucketed, tile-aligned, shard-striped packing of the live paths.

    ``perm (n_packed,)`` maps packed slot -> dense flat path index
    (``t * L + l``); pad slots point at slot 0 and are masked by ``live``.
    ``buckets`` are ``(start, stop, dmax)`` slices in LOCAL (per-shard)
    packed coordinates — identical on every shard by construction, so a
    shard_map body can iterate them as static structure.  For
    ``shards == 1`` local coordinates are global.  ``n_packed`` is always
    ``shards * local_len``; shard ``r`` owns ``perm[r*local_len :
    (r+1)*local_len]``.
    """

    perm: np.ndarray
    live: np.ndarray
    buckets: Tuple[Tuple[int, int, int], ...]
    tile: int
    shards: int
    n_live: int
    n_dense: int
    dmax_global: int
    #: modelled kernel work (tiles x tile x dmax), packed vs dense layout
    work_packed: int = 0
    work_dense: int = 0
    #: max/mean per-shard live work (1.0 = perfectly balanced)
    shard_balance: float = 1.0
    stats: dict = field(default_factory=dict)

    @property
    def n_packed(self) -> int:
        return int(self.perm.shape[0])

    @property
    def local_len(self) -> int:
        return self.n_packed // max(1, self.shards)

    @property
    def gain(self) -> float:
        """Modelled dense/packed work ratio (>1 = packing saves work)."""

        return self.work_dense / max(1, self.work_packed)

    def fingerprint(self) -> str:
        import hashlib

        h = hashlib.sha256()
        h.update(self.perm.tobytes())
        h.update(self.live.tobytes())
        h.update(repr((self.buckets, self.tile, self.shards)).encode())
        return h.hexdigest()[:16]


def _depth_buckets(sorted_counts: np.ndarray) -> list:
    """Split descending-sorted counts into buckets whose members are all
    >= half the bucket's max: the per-bucket static ``dmax`` then wastes
    < 2x binomial-loop steps on any member."""

    buckets = []          # list of (n_paths, dmax)
    i = 0
    n = sorted_counts.shape[0]
    while i < n:
        dmax = int(sorted_counts[i])
        # members while count >= ceil(dmax / 2)
        j = int(np.searchsorted(-sorted_counts, -((dmax + 1) // 2),
                                side="right"))
        buckets.append([j - i, dmax])
        i = j
    return buckets


def plan_packed_paths(counts: np.ndarray, tile: int = DEFAULT_TILE,
                      shards: int = 1,
                      dmax_cap: Optional[int] = None) -> PackedPathPlan:
    """Build the packed layout from :func:`leaf_group_counts` output.

    Paths are sorted by group count (descending), bucketed by
    :func:`_depth_buckets`, and each bucket padded to a whole number of
    ``tile * shards`` slots; tiles are striped round-robin over shards so
    every shard gets the same tile count per bucket.  Buckets smaller
    than half a stripe are merged into their deeper neighbour — a bucket
    costs a separate kernel launch per background slice, so fragmenting
    the tail into tiny buckets would trade pad waste for launch/trace
    overhead.  ``dmax_cap`` (if given) only annotates: buckets deeper
    than the cap keep their true dmax (the dispatcher routes them off
    the capped kernel).
    """

    counts = np.asarray(counts)
    T, L = counts.shape
    flat = counts.ravel()
    live_idx = np.nonzero(flat > 0)[0]
    n_live = int(live_idx.shape[0])
    dmax_global = int(flat.max(initial=0)) if n_live else 0
    stripe = tile * max(1, shards)

    if n_live == 0:
        # degenerate (every path dead or group-free): one empty stripe so
        # downstream shapes stay legal; live mask kills all contributions
        perm = np.zeros((stripe,), np.int32)
        live = np.zeros((stripe,), bool)
        return PackedPathPlan(
            perm=perm, live=live,
            buckets=((0, tile, 1),), tile=tile, shards=max(1, shards),
            n_live=0, n_dense=T * L, dmax_global=0,
            work_packed=tile, work_dense=tile, shard_balance=1.0)

    order = np.argsort(-flat[live_idx], kind="stable")
    sorted_idx = live_idx[order]
    sorted_cnt = flat[sorted_idx]

    raw = _depth_buckets(sorted_cnt)
    # merge sub-half-stripe buckets into the previous (deeper) one: the
    # deeper dmax is correct for the merged members, just less tight
    merged = []
    for n_b, dmax in raw:
        if merged and n_b < stripe // 2:
            merged[-1][0] += n_b
        else:
            merged.append([n_b, dmax])
    # a sub-stripe FIRST bucket has nothing deeper to merge into; keep it

    shards = max(1, int(shards))
    # per-bucket: pad to a whole stripe, stripe tiles round-robin so each
    # shard holds tiles_per_shard tiles of this bucket
    local_chunks = [[] for _ in range(shards)]   # per-shard (perm, live)
    local_buckets = []
    local_pos = 0
    src = 0
    shard_work = np.zeros(shards, np.int64)
    work_packed = 0
    pad_slots = 0
    for n_b, dmax in merged:
        members = sorted_idx[src:src + n_b]
        member_cnt = sorted_cnt[src:src + n_b]
        src += n_b
        n_tiles = -(-n_b // stripe) * shards      # tiles total, per bucket
        tiles_per_shard = n_tiles // shards
        padded = n_tiles * tile
        perm_b = np.zeros((padded,), np.int64)
        live_b = np.zeros((padded,), bool)
        perm_b[:n_b] = members
        live_b[:n_b] = True
        pad_slots += padded - n_b
        cnt_b = np.zeros((padded,), np.int64)
        cnt_b[:n_b] = member_cnt
        # strided deal: member m -> tile m % n_tiles, so every tile gets an
        # even mix of the bucket's longest and shortest paths (and the pad
        # tail spreads across tiles) — contiguous fill would concentrate
        # the deep paths in the first tile and skew the shard stripe
        tiles = perm_b.reshape(tile, n_tiles).T
        livet = live_b.reshape(tile, n_tiles).T
        cntt = cnt_b.reshape(tile, n_tiles).T
        for r in range(shards):
            sel = slice(r, n_tiles, shards)
            local_chunks[r].append((tiles[sel].ravel(), livet[sel].ravel()))
            shard_work[r] += int(cntt[sel].sum())
        local_buckets.append((local_pos,
                              local_pos + tiles_per_shard * tile, dmax))
        local_pos += tiles_per_shard * tile
        work_packed += n_tiles * tile * max(1, dmax)

    perm = np.concatenate([np.concatenate([c[0] for c in chunks])
                           for chunks in local_chunks]).astype(np.int32)
    live = np.concatenate([np.concatenate([c[1] for c in chunks])
                           for chunks in local_chunks])

    dense_tiles = -(-T * L // tile)
    work_dense = dense_tiles * tile * max(1, dmax_global)
    mean_work = float(shard_work.mean()) or 1.0
    return PackedPathPlan(
        perm=perm, live=live, buckets=tuple(local_buckets), tile=tile,
        shards=shards, n_live=n_live, n_dense=T * L,
        dmax_global=dmax_global,
        work_packed=int(work_packed), work_dense=int(work_dense),
        shard_balance=float(shard_work.max() / mean_work),
        stats={"pad_slots": int(pad_slots), "n_buckets": len(local_buckets),
               "bucket_dmax": [d for _, _, d in local_buckets],
               "dropped_zero_group": int((flat == 0).sum()),
               "shard_work": shard_work.tolist()})
