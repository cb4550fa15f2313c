"""DKS-J002 known-bad: writes into cache-resident constants -- in place,
through ``out=`` and as a kernel launch's output pointer."""

from collections import OrderedDict

import torch


class Engine:
    def __init__(self):
        self._dev_cache = OrderedDict()
        self._plan_consts_cache = OrderedDict()

    def _exact_consts(self):
        return self._plan_consts_cache[("exact_consts", "fp")]

    def _device_args(self, plan):
        return self._dev_cache[plan]

    def explain(self, X, plan=None):
        mask = self._device_args(plan)[3]
        mask.zero_()                                 # a _dev_cache entry by its accessor
        consts = self._exact_consts()
        consts["bgw"].div_(consts["bgw"].sum())      # normalises the cached weights
        bg = self._dev_cache["bg"][0]
        bg.sub_(X.mean(0))                           # an alias of a cache entry
        torch.mul(X, 2.0, out=self._plan_consts_cache["scratch"])
        return bg


def launch(lib, x, consts):
    lib.kernel_launch(x.data_ptr(), consts["out"].data_ptr(), x.shape[0])
