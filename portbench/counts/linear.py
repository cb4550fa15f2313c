"""Work of KernelSHAP on a softmax linear model of more than two classes.

``masked_eval``: ``ey[b, s, k] = Σ_n w_n softmax(logits of x_b masked by
coalition s with background row n)[k]`` for B rows, S coalitions, N
background rows, M groups over D columns and K classes.  The logits split
into an instance part ``a[b, s] = Σ_g mask[s, g] (x_b W)_g`` and a
background part ``c[s, n]``, so every exponential factors as
``e^a · e^c``: K (B S + S N) exponentials, the rank-K contraction
``D[b, s, n] = Σ_k e^a e^c`` (2 B S N K FLOP), one reciprocal ``w_n / D``
per (b, s, n), the contraction ``Σ_n (w_n / D) e^c`` (2 B S N K FLOP), and
the group contractions forming ``a`` and ``c`` (2 M K (B S + S N) FLOP).
(A binary softmax or a sigmoid needs less: its count belongs with the
first cell that runs one.)

Bytes: the rows, the background, the weights, the background weights and
the plan's mask read once, ``ey`` written once.

``explain`` adds what the rest of a call needs: the link of every
``ey`` (a logarithm each), the weighted least squares' right-hand sides
(``2 B K S (M-1)`` FLOP of contraction) and solve, the rows read and phi
and f(x) written; ``ey`` itself is not counted as traffic, since a fused
implementation need not store it.
"""

from portbench.counts.roofline import add, empty


def masked_eval(B, S, N, M, K, D):
    if K <= 2:
        raise ValueError("counted for the general softmax (K > 2) only")
    w = empty()
    bss = B * S + S * N
    w["special"] = K * bss + float(B) * S * N
    w["contraction_flop"] = 2.0 * M * K * bss + 4.0 * B * S * N * K
    w["bytes"] = 4.0 * (B * D + N * D + D * K + K + N + S * M + B * S * K)
    return w


def explain(B, S, N, M, K, D, phi_bytes, return_phi=True):
    """One call over ``B`` rows: the masked evaluation, the link, the least
    squares; phi written at ``phi_bytes`` an element when ``return_phi``
    (``rank_features`` returns only the ``(K, M)`` importance)."""

    ey = masked_eval(B, S, N, M, K, D)
    ey["bytes"] = 4.0 * (B * D + N * D + D * K + K + N + S * M)
    rest = empty()
    rest["special"] = float(B) * S * K
    rest["fp32_flop"] = 2.0 * B * S * K
    rest["contraction_flop"] = 2.0 * B * K * S * (M - 1) + 2.0 * S * (M - 1) ** 2 \
        + 2.0 * B * K * (M - 1) ** 2
    rest["bytes"] = (phi_bytes * B * K * M if return_phi else 4.0 * K * M) + 4.0 * B * K
    return add(ey, rest)
