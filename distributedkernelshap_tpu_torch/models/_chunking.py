"""Shared padded-chunk mapping for the structure-aware masked evaluations.

Port of ``distributedkernelshap_tpu/models/_chunking.py``.  One helper so the
tree and MLP ``masked_ey`` implementations are only the per-model math: pad
the leading axis to a multiple of ``chunk``, run ``fn`` per chunk (a Python
loop, where the JAX package uses ``lax.map``), and return the concatenated
result sliced back to the original length.

``fn`` must map ``(chunk, *in_tail) -> (chunk, *out_tail)``: the leading
axis of its output corresponds elementwise to its input chunk.  Padding rows
are zeros; callers make sure pad rows are harmless (zero masks evaluate the
pure background, zero instances produce rows that are sliced away).
"""

import torch

#: default per-chunk element budget shared by every masked_ey implementation
#: (f32: 4 bytes/element; 1<<25 elements ≈ 128 MB)
DEFAULT_CHUNK_ELEMS: int = 1 << 25


def padded_chunk_map(fn, arr: torch.Tensor, chunk: int) -> torch.Tensor:
    n = arr.shape[0]
    chunk = max(1, min(n, int(chunk)))
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        arr = torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))], 0)
    out = torch.cat([fn(arr[i * chunk:(i + 1) * chunk]) for i in range(n_chunks)], 0)
    return out[:n]


def first_layer_separated_ey(W1, b1, tail_fn, X, bg, bgw_n, mask, G,
                             budget: int, coalition_chunk=None,
                             h_max: int = None):
    """Masked expected outputs for networks whose FIRST layer is dense.

    The first layer is linear in the synthetic row, so its pre-activations
    separate into instance + background group-space terms (the ``_ey_linear``
    decomposition); ``tail_fn`` applies everything after the first layer's
    pre-activations to the assembled ``(chunk, B, N, H)`` tensor and must
    return ``(chunk, B, N, K)``.  Shared by the scikit-learn and torch MLP
    ``masked_ey`` implementations.  Only per-chunk tensors scale with ``B``;
    the persistent background-side terms are ``N·M·H``.
    """

    X = X.to(torch.float32)
    bg = bg.to(torch.float32)
    mask = mask.to(torch.float32)
    Gm = G.to(torch.float32)
    B, N, S = X.shape[0], bg.shape[0], mask.shape[0]
    M = mask.shape[1]
    H = W1.shape[1]
    h_max = max(H, h_max or 0)

    bgW = bg @ W1 + b1[None, :]                              # (N, H)
    bgWg = torch.einsum("nd,md,dh->nmh", bg, Gm, W1)         # (N, M, H)
    bc = max(1, min(B, budget // max(1, N * h_max, M * H)))
    sc = coalition_chunk or max(1, min(S, budget // max(1, bc * N * h_max)))

    def b_chunk(Xc):
        XWg = torch.einsum("bd,md,dh->bmh", Xc, Gm, W1)      # (bc, M, H)

        def s_chunk(mask_c):
            p1 = torch.einsum("cm,bmh->cbh", mask_c, XWg)
            t2 = torch.einsum("cm,nmh->cnh", mask_c, bgWg)
            z1 = p1[:, :, None, :] + bgW[None, None] - t2[:, None]
            return torch.einsum("cbnk,n->cbk", tail_fn(z1), bgw_n)

        ey_c = padded_chunk_map(s_chunk, mask, sc)           # (S, bc, K)
        return ey_c.movedim(0, 1)                            # (bc, S, K)

    return padded_chunk_map(b_chunk, X, bc)                  # (B, S, K)
