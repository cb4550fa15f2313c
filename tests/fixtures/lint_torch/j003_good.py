"""DKS-J003 known-good twin: the device function draws with a generator it
is handed and reads only shapes on the host; the clock and the fetch live
in the dispatcher around it."""

import time

import torch


def build_clean_fn(scale):
    def fn(X, bg, gen):
        B = int(X.shape[0])
        noise = torch.randn(tuple(X.shape), generator=gen, device=X.device)
        return X * scale + noise[:B] + bg.mean(0) * len(bg)

    return fn


def dispatch(fn, X, bg, gen):
    t0 = time.perf_counter()
    out = fn(X, bg, gen)
    return out.cpu().numpy(), time.perf_counter() - t0
