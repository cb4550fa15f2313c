"""Exact interventional Shapley values and interactions of a tree ensemble
over column groups, in plain PyTorch.

For one explained row ``x``, one background row ``z`` and one leaf with
value ``val`` on a root path of splits ``x_f <= t`` (left) or ``x_f > t``
(right), call a group of the path satisfied by a row when the row takes
every split of the path on that group's columns.  The hybrid row that takes
``x`` on a coalition ``S`` of groups and ``z`` elsewhere reaches the leaf
exactly when every path group satisfied by ``x`` only is in ``S``, every
path group satisfied by ``z`` only is outside it, and no path group is
satisfied by neither.  With ``u`` groups of the first kind (``U``) and
``v`` of the second (``V``), that reach is a unanimity game whose Shapley
values and pairwise interaction indices are

    phi_g = val (u-1)! v! / (u+v)!      g in U;   -val u! (v-1)! / (u+v)!   g in V
    I_gh  = val (u-2)! v! / (u+v-1)!    g, h in U
          = val u! (v-2)! / (u+v-1)!    g, h in V
          = -val (u-1)! (v-1)! / (u+v-1)!   one in U, one in V

summed over leaves and trees and averaged over the weighted background
rows.  The interaction matrices follow shap's convention: ``I_gh / 2`` off
the diagonal and ``phi_g - Σ_{h != g} I_gh / 2`` on it.  The leaves and their
paths are read from the node tables by walking each tree from its root.
"""

from math import factorial

import numpy as np
import torch


def leaf_paths(tables):
    """``(feature (P, L), threshold (P, L), left (P, L) bool, valid (P, L)
    bool, value (P,), tree (P,))``: every leaf reachable from its tree's
    root with the splits on its path (a node whose children are itself is a
    leaf)."""

    feat, thr = tables["feature"], tables["threshold"]
    left, right, value = tables["left"], tables["right"], tables["value"]
    paths = []
    for t in range(feat.shape[0]):
        stack = [(0, [])]
        while stack:
            node, conds = stack.pop()
            lc, rc = int(left[t, node]), int(right[t, node])
            if lc == node and rc == node:
                paths.append((conds, float(value[t, node, 0]), t))
                continue
            f, th = int(feat[t, node]), float(thr[t, node])
            stack.append((rc, conds + [(f, th, False)]))
            stack.append((lc, conds + [(f, th, True)]))
    L = max(1, max(len(c) for c, _, _ in paths))
    P = len(paths)
    f_out = np.zeros((P, L), np.int64)
    t_out = np.zeros((P, L), np.float32)
    l_out = np.zeros((P, L), bool)
    v_out = np.zeros((P, L), bool)
    for p, (conds, _, _) in enumerate(paths):
        for j, (f, th, go_left) in enumerate(conds):
            f_out[p, j], t_out[p, j], l_out[p, j], v_out[p, j] = f, th, go_left, True
    vals = np.array([v for _, v, _ in paths], np.float64)
    trees = np.array([t for _, _, t in paths], np.int64)
    return f_out, t_out, l_out, v_out, vals, trees


def group_failures(rows, paths, col_group, M):
    """``(fails (R, P, M) bool, on_path (P, M) bool)``: path groups a row
    does not satisfy, and the groups on each path."""

    feat, thr, go_left, valid = paths[:4]
    xs = rows[:, feat]                                       # (R, P, L)
    takes = (xs <= thr[None]) == go_left[None]
    miss = (~takes) & valid[None]                            # (R, P, L)
    onehot = torch.nn.functional.one_hot(col_group[feat], M).to(rows.dtype)  # (P, L, M)
    onehot = onehot * valid[..., None].to(rows.dtype)
    fails = torch.einsum("rpl,plm->rpm", miss.to(rows.dtype), onehot) > 0.5
    on_path = onehot.sum(1) > 0.5
    return fails, on_path


def _weights(D, dtype, device):
    """Tables indexed ``[u, v]`` of the phi and interaction weights."""

    f = [float(factorial(i)) for i in range(2 * D + 2)]
    phi_u = np.zeros((D + 1, D + 1))
    phi_v = np.zeros((D + 1, D + 1))
    i_uu = np.zeros((D + 1, D + 1))
    i_vv = np.zeros((D + 1, D + 1))
    i_uv = np.zeros((D + 1, D + 1))
    for u in range(D + 1):
        for v in range(D + 1):
            if u >= 1:
                phi_u[u, v] = f[u - 1] * f[v] / f[u + v]
            if v >= 1:
                phi_v[u, v] = -f[u] * f[v - 1] / f[u + v]
            if u >= 2:
                i_uu[u, v] = f[u - 2] * f[v] / f[u + v - 1]
            if v >= 2:
                i_vv[u, v] = f[u] * f[v - 2] / f[u + v - 1]
            if u >= 1 and v >= 1:
                i_uv[u, v] = -f[u - 1] * f[v - 1] / f[u + v - 1]
    return [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (phi_u, phi_v, i_uu, i_vv, i_uv)]


def explain(X, bg, bgw, tables, groups, *, base=0.0, interactions=True,
            dtype=torch.float64, device="cpu", row_block=16):
    """``(phi (B, M), E, f(x) (B,), inter (B, M, M) or None)`` as numpy
    float64 for the numpy rows ``X`` of a sum-of-trees regressor with
    offset ``base`` over the column ``groups`` (every column in one group)."""

    dev = torch.device(device)
    M = len(groups)
    D = X.shape[1]
    col_group = np.full(D, -1, np.int64)
    for g, cols in enumerate(groups):
        col_group[list(cols)] = g
    if (col_group < 0).any():
        raise ValueError("every column must belong to a group")
    feat, thr, go_left, valid, vals, _ = leaf_paths(tables)
    paths = (torch.as_tensor(feat, device=dev), torch.as_tensor(thr, device=dev),
             torch.as_tensor(go_left, device=dev), torch.as_tensor(valid, device=dev))
    cg = torch.as_tensor(col_group, device=dev)
    val = torch.as_tensor(vals, dtype=dtype, device=dev)
    w = torch.as_tensor(np.asarray(bgw, np.float64), dtype=dtype, device=dev)
    w = w / w.sum()
    Dmax = M
    phi_u, phi_v, i_uu, i_vv, i_uv = _weights(Dmax, dtype, dev)

    def model(rows):
        fails, _ = group_failures(rows, paths, cg, M)
        reach = (~fails.any(-1)).to(dtype)                   # (R, P)
        return base + reach @ val

    bg_t = torch.as_tensor(np.asarray(bg, np.float32), device=dev)
    with torch.no_grad():
        z_fail, on_path = group_failures(bg_t, paths, cg, M)    # (N, P, M)
        E = float((model(bg_t) * w).sum())
        phis, fxs, inters = [], [], []
        for r0 in range(0, X.shape[0], row_block):
            x = torch.as_tensor(np.asarray(X[r0:r0 + row_block], np.float32), device=dev)
            x_fail, _ = group_failures(x, paths, cg, M)         # (R, P, M)
            xf, zf = x_fail[:, None], z_fail[None]              # (R, 1, P, M), (1, N, P, M)
            dead = (xf & zf & on_path).any(-1)                  # (R, N, P)
            U = (~xf & zf & on_path) & ~dead[..., None]         # (R, N, P, M)
            V = (xf & ~zf & on_path) & ~dead[..., None]
            u, v = U.sum(-1), V.sum(-1)
            scale = w[None, :, None] * val[None, None, :]       # (1, N, P)
            Uf, Vf = U.to(dtype), V.to(dtype)
            cu, cv = phi_u[u, v] * scale, phi_v[u, v] * scale   # (R, N, P)
            phi = torch.einsum("rnp,rnpm->rm", cu, Uf) + torch.einsum("rnp,rnpm->rm", cv, Vf)
            phis.append(phi.double().cpu().numpy())
            fxs.append(model(x).double().cpu().numpy())
            if interactions:
                R, N, P = u.shape
                a = (i_uu[u, v] * scale)[..., None] * Uf + (i_uv[u, v] * scale)[..., None] * Vf
                c = (i_vv[u, v] * scale)[..., None] * Vf + (i_uv[u, v] * scale)[..., None] * Uf
                pair = (torch.einsum("rnpg,rnph->rgh", a, Uf)
                        + torch.einsum("rnpg,rnph->rgh", c, Vf))
                eye = torch.eye(M, dtype=dtype, device=dev)
                off = pair * (1.0 - eye) * 0.5
                inter = off + (phi - off.sum(-1))[..., None] * eye
                inters.append(inter.double().cpu().numpy())
    return (np.concatenate(phis), E, np.concatenate(fxs),
            np.concatenate(inters) if interactions else None)
