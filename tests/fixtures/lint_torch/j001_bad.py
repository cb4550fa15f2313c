"""DKS-J001 known-bad: in-place writes into a caller's tensor and into
object state, outside the audited allowlist."""

import torch


def scale_rows(x, w):
    x.mul_(w[:, None])          # writes the caller's tensor
    return x


class Running:
    def __init__(self, n):
        self.total = torch.zeros(n)

    def add(self, x):
        torch.add(self.total, x, out=self.total)    # out= into object state

    def reset(self):
        flat = self.total.view(-1)
        flat.zero_()                                 # through a view of it
