"""Mini engine, port-shaped: one dispatch entry + fingerprint-keyed consts
builder per structured path, every builder storing through the one LRU
helper ``_shared_consts``."""

from collections import OrderedDict


class Engine:
    _DEV_CACHE_MAX_ENTRIES = 8

    def __init__(self):
        self._plan_consts_cache = OrderedDict()

    def content_fingerprint(self):
        return "fp"

    def _plan_consts(self, plan, chunk):
        key = (self.content_fingerprint(), chunk)
        return self._shared_consts(key, lambda: {"plan": plan})

    def _shared_consts(self, key, build):
        if key in self._plan_consts_cache:
            self._plan_consts_cache.move_to_end(key)
            return self._plan_consts_cache[key]
        consts = build()
        self._plan_consts_cache[key] = consts
        while len(self._plan_consts_cache) > self._DEV_CACHE_MAX_ENTRIES:
            self._plan_consts_cache.popitem(last=False)
        return consts

    def _exact_consts(self):
        return self._shared_consts(("exact_consts", self.content_fingerprint()),
                                   lambda: {"reach": None})

    def _dispatch_array(self, X, plan):
        consts = self._plan_consts(plan, 1)
        return consts

    def _dispatch_exact(self, X):
        consts = self._exact_consts()
        return consts
