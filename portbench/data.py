"""Seeded inputs: rows from a configuration's column groups, host draws.

Every array a cell uses is made here from ``--seed`` and a tag naming what
it is for, so the same seed gives the same inputs and two draws never share
a stream.  Large row tensors are drawn on the run's device with a
``torch.Generator`` in one call per group; the few small parameters
(class shares, model weights, tree splits) are drawn on the host.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch


def _state(seed: int, tag: str) -> List[int]:
    """The entropy of the stream named ``tag`` under ``seed``."""

    return [int(seed) & ((1 << 64) - 1), int(seed) >> 64] + [ord(c) for c in tag]


def host_rng(seed: int, tag: str) -> np.random.Generator:
    """A numpy generator for the small host-side draws named ``tag``."""

    return np.random.default_rng(_state(seed, tag))


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the row draws named ``tag``."""

    word = np.random.SeedSequence(_state(seed, tag)).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(word) & ((1 << 63) - 1))
    return gen


def group_widths(groups: Sequence[Dict]) -> List[int]:
    """Column count of each group of a configuration's ``groups``."""

    return [int(g.get("width", 1)) for g in groups]


def group_columns(groups: Sequence[Dict]) -> List[List[int]]:
    """The column indices of each group, in order."""

    out, start = [], 0
    for w in group_widths(groups):
        out.append(list(range(start, start + w)))
        start += w
    return out


def make_rows(groups: Sequence[Dict], n: int, seed: int, tag: str, device) -> np.ndarray:
    """``n`` float32 rows over ``groups``, in group order: a ``normal``
    group is one standard normal column, ``binary`` one 0/1 column, and
    ``onehot`` a one-hot block of ``width`` columns whose categories are
    drawn with shares from a Dirichlet of the given ``concentration``
    (uniform shares when it is null)."""

    rng = host_rng(seed, tag + ".shares")
    gen = device_generator(seed, tag, device)
    dev = torch.device(device)
    cols = []
    for g in groups:
        kind, width = g["kind"], int(g.get("width", 1))
        if kind == "normal":
            cols.append(torch.randn((n, 1), generator=gen, device=dev))
        elif kind == "binary":
            cols.append(torch.randint(0, 2, (n, 1), generator=gen, device=dev).float())
        elif kind == "onehot":
            alpha = g.get("concentration")
            shares = (np.full(width, 1.0 / width) if alpha is None
                      else rng.dirichlet(np.full(width, float(alpha))))
            idx = torch.multinomial(torch.as_tensor(shares, dtype=torch.float32, device=dev),
                                    n, replacement=True, generator=gen)
            cols.append(torch.nn.functional.one_hot(idx, width).float())
        else:
            raise ValueError(f"unknown column group kind {kind!r}")
    return torch.cat(cols, 1).cpu().numpy().astype(np.float32)
