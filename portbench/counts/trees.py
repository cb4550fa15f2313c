"""Work of exact interventional TreeSHAP and its interactions, counted from
the data.

For an explained row b, a background row n and a leaf path p, the path's
groups fall into those both rows satisfy, ``U`` (x only), ``V`` (z only)
and those neither does, which kills the triple (see
``reference/treeshap.py``).  Which groups ``x`` fails is fixed for (b, p), so
for every live n ``V`` is the same set, and only ``U`` varies with n.  The
least a triple takes, over all triples whose path has a group:

- integer lanes: 2 operations (the dead test and the count of ``U`` on a
  word of group bits);
- phi: one multiply for its weight, one add for the ``V`` scalar of
  (b, p) and one add per group of ``U`` (live triples with ``u + v >= 1``);
- interactions: one multiply, one add for the ``V`` pairs, one per group of
  ``U`` for the ``U``-``V`` pairs and one per pair of ``U`` (live triples
  with ``u + v >= 2``).

Which triples are live and their ``u`` come from the data, so the counts
are made on the device in blocks of rows, from the reference's reach
tests (``reference/treeshap.group_failures``).  Bytes: the rows, the background, the trees' split and leaf tables
read once, the outputs written once.
"""

import torch

from portbench.counts.roofline import add, empty


def triple_stats(x_fail, z_fail, on_path, row_block=16):
    """Sums over (b, n, p): ``on`` (triples whose path has a group),
    ``phi_fp`` and ``inter_fp`` (the float operations above)."""

    has_group = on_path.any(-1)                                  # (P,)
    B, N = x_fail.shape[0], z_fail.shape[0]
    stats = {"on": float(B) * N * int(has_group.sum()), "phi_fp": 0.0, "inter_fp": 0.0}
    zf = z_fail[None]
    for r0 in range(0, B, row_block):
        xf = x_fail[r0:r0 + row_block, None]
        dead = (xf & zf & on_path).any(-1)
        u = ((~xf & zf & on_path).sum(-1)).to(torch.float64)
        v = ((xf & ~zf & on_path).sum(-1)).to(torch.float64)
        live = ~dead & has_group
        stats["phi_fp"] += float(((u + 2.0) * (live & (u + v >= 1))).sum())
        stats["inter_fp"] += float(((u * (u - 1.0) / 2.0 + u + 2.0)
                                    * (live & (u + v >= 2))).sum())
    return stats


def table_bytes(n_internal: int, n_leaves: int, K: int = 1) -> float:
    """A split's column and threshold, a leaf's values."""

    return 8.0 * n_internal + 4.0 * K * n_leaves


def _io(B, N, D, tables_b):
    w = empty()
    w["bytes"] = 4.0 * (B * D + N * D) + tables_b
    return w


def interactions(stats, B, N, D, M, tables_b, K=1):
    """The interaction sums alone (``exact_tree_inter``'s work)."""

    w = _io(B, N, D, tables_b)
    w["bytes"] += 4.0 * B * M * M * K
    w["int_ops"] = 2.0 * stats["on"]
    w["fp32_flop"] = stats["inter_fp"] * K
    return w


def explain_interactions(stats, B, N, D, M, n_internal, tables_b, K=1):
    """One ``explain(nsamples='exact', interactions=True)`` call: the reach
    tests of the rows (a comparison per row and split), phi, the
    interaction sums and the matrices' diagonals; phi, the matrices and
    f(x) written."""

    w = interactions(stats, B, N, D, M, tables_b, K)
    extra = empty()
    extra["fp32_flop"] = float(B) * n_internal + stats["phi_fp"] * K + float(B) * M * M * K
    extra["bytes"] = 4.0 * B * M * K + 4.0 * B * K
    return add(w, extra)
