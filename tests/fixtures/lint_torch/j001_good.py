"""DKS-J001 known-good twin: the same work writing only tensors the
function allocates, and rebinding object state instead of writing it."""

import torch


def scale_rows(x, w):
    out = x.clone()
    out.mul_(w[:, None])        # the clone is this function's own
    return out


class Running:
    def __init__(self, n):
        self.total = torch.zeros(n)

    def add(self, x):
        out = torch.empty_like(x)
        torch.add(self.total, x, out=out)            # out= into a fresh tensor
        self.total = out

    def reset(self):
        self.total = torch.zeros_like(self.total)    # a rebind, not a write
