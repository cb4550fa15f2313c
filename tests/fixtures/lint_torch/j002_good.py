"""DKS-J002 known-good twin: the cached constants are read, cloned or
handed to a kernel as inputs; every write lands in a per-call tensor."""

from collections import OrderedDict

import torch


class Engine:
    def __init__(self):
        self._dev_cache = OrderedDict()
        self._plan_consts_cache = OrderedDict()

    def _exact_consts(self):
        return self._plan_consts_cache[("exact_consts", "fp")]

    def explain(self, X):
        consts = self._exact_consts()
        bgw = consts["bgw"] / consts["bgw"].sum()    # a new tensor
        bg = self._dev_cache["bg"][0].clone()
        bg.sub_(X.mean(0))                           # writes the clone
        scratch = torch.empty_like(X)
        torch.mul(X, 2.0, out=scratch)
        return bg * bgw.sum() + scratch


def launch(lib, x, consts):
    out = torch.empty_like(x)
    lib.kernel_launch(consts["bgw"].data_ptr(), out.data_ptr(), x.shape[0])
    return out
