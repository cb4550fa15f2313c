"""KernelSHAP of a softmax linear model, in plain PyTorch.

For rows ``x``, background rows ``bg_n`` with weights ``w_n`` (summing to
1), a coalition plan ``(mask, weights)`` over column groups ``G`` and the
model ``p(m) = softmax(m W + b)``:

- ``ey[b, s] = Σ_n w_n p(x_b ⊙ z_s + bg_n ⊙ (1 - z_s))`` with ``z_s = mask_s G``.
  The logits of the masked row are ``bg_n W + b + Σ_g mask[s, g] ·
  Σ_{d ∈ g} (x_bd - bg_nd) W_d``, the same numbers without forming the
  masked rows;
- the link ``logit(p) = log(p / (1 - p))`` with ``p`` clipped to
  ``[1e-7, 1 - 1e-7]``, as the configuration's link is defined;
- ``E = link(Σ_n w_n p(bg_n))``, ``f(x) = link(p(x))``;
- phi: the Shapley-kernel weighted least squares over the plan's rows with
  ``Σ_g phi_g = f(x) - E`` imposed by eliminating the last group, a ridge
  on the diagonal of the reduced normal equations, solved by
  ``torch.linalg.solve``.

Everything runs in the dtype asked for; with float32 on a GPU the caller
decides whether TF32 may serve the products (the benchmark's control asks
for it, the reference does not).
"""

import numpy as np
import torch

LOGIT_EPS = 1e-7


def link(p, name: str):
    if name == "identity":
        return p
    if name != "logit":
        raise ValueError(f"unknown link {name!r}")
    p = p.clamp(LOGIT_EPS, 1.0 - LOGIT_EPS)
    return torch.log(p / (1.0 - p))


def _probs(logits):
    return torch.softmax(logits, dim=-1)


def expected_value(bg, bgw, W, b, link_name):
    """``E`` in link space: ``(K,)``."""

    return link(torch.einsum("nk,n->k", _probs(bg @ W + b), bgw), link_name)


def masked_ey(X, bg, bgw, W, b, G, mask, coalition_block: int):
    """``ey (B, S, K)``: the weighted mean over the background of the model's
    probabilities on every coalition's masked rows."""

    GW = G[:, :, None] * W[None]                         # (M, D, K)
    XWg = torch.einsum("bd,mdk->bmk", X, GW)
    bgWg = torch.einsum("nd,mdk->nmk", bg, GW)
    diff = XWg[:, None] - bgWg[None]                     # (B, N, M, K)
    base = bg @ W + b                                    # (N, K)
    out = []
    for s0 in range(0, mask.shape[0], coalition_block):
        m = mask[s0:s0 + coalition_block]
        logits = torch.einsum("sm,bnmk->bsnk", m, diff) + base[None, None]
        out.append(torch.einsum("bsnk,n->bsk", _probs(logits), bgw))
    return torch.cat(out, 1)


def wls(mask, weights, ey_adj, fx_minus_e, ridge):
    """phi ``(B, K, M)`` of the constrained weighted least squares."""

    B, S, K = ey_adj.shape
    M = mask.shape[1]
    if M == 1:
        return fx_minus_e[:, :, None]
    last = mask[:, -1:]
    Z = mask[:, :-1] - last                              # (S, M-1)
    Zw = Z * weights[:, None]
    A = Zw.T @ Z + ridge * torch.eye(M - 1, dtype=Z.dtype, device=Z.device)
    target = ey_adj - last[None] * fx_minus_e[:, None, :]           # (B, S, K)
    rhs = torch.einsum("sm,bsk->mbk", Zw, target).reshape(M - 1, B * K)
    head = torch.linalg.solve(A, rhs).reshape(M - 1, B, K).permute(1, 2, 0)
    tail = fx_minus_e - head.sum(-1)
    return torch.cat([head, tail[..., None]], -1)


def explain(X, bg, bgw, W, b, G, mask, weights, *, link_name="logit", ridge=1e-6,
            dtype=torch.float64, device="cpu", row_block=256, coalition_block=256,
            transfer_dtype=None):
    """``(phi (B, K, M), E (K,), f(x) (B, K))`` as numpy float64 for the
    numpy rows ``X``, in ``row_block`` rows at a time.  ``transfer_dtype``
    rounds phi as the configuration's result copy does (only the control,
    which stands in the port's place, asks for it)."""

    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
    bg_t, W_t, b_t, G_t = t(bg), t(W), t(b), t(G)
    bgw_t = t(bgw)
    bgw_t = bgw_t / bgw_t.sum()
    mask_t, w_t = t(mask), t(weights)
    with torch.no_grad():
        E = expected_value(bg_t, bgw_t, W_t, b_t, link_name)
        phis, fxs = [], []
        for r0 in range(0, X.shape[0], row_block):
            x = t(X[r0:r0 + row_block])
            fx = link(_probs(x @ W_t + b_t), link_name)
            ey = masked_ey(x, bg_t, bgw_t, W_t, b_t, G_t, mask_t, coalition_block)
            phi = wls(mask_t, w_t, link(ey, link_name) - E, fx - E, ridge)
            if transfer_dtype:
                phi = phi.to(getattr(torch, transfer_dtype)).to(dtype)
            phis.append(phi.double().cpu().numpy())
            fxs.append(fx.double().cpu().numpy())
    return np.concatenate(phis), E.double().cpu().numpy(), np.concatenate(fxs)


def mean_abs_phi(X, bg, bgw, W, b, G, mask, weights, *, link_name="logit", ridge=1e-6,
                 dtype=torch.float32, device="cpu", row_block=2048, coalition_block=128):
    """``(K, M)`` mean of |phi| over all rows of ``X`` (accumulated in
    float64), the global importance ``rank_features`` reports."""

    total = None
    for r0 in range(0, X.shape[0], row_block):
        phi = explain(X[r0:r0 + row_block], bg, bgw, W, b, G, mask, weights,
                      link_name=link_name, ridge=ridge, dtype=dtype, device=device,
                      row_block=row_block, coalition_block=coalition_block)[0]
        part = np.abs(phi).sum(0)
        total = part if total is None else total + part
    return total / X.shape[0]
