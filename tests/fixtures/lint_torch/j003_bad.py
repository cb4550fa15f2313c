"""DKS-J003 known-bad: host RNG, a clock read and host syncs inside the
closure a ``build_*_fn`` builder returns (and in a helper it reaches)."""

import random
import time

import numpy as np
import torch


def _host_norm(x):
    return np.linalg.norm(x.cpu().numpy())


def build_noisy_fn(scale):
    def fn(X, bg):
        noise = np.random.normal(size=tuple(X.shape))
        t0 = time.perf_counter()
        jitter = random.random()
        total = float(X.sum())
        peak = X.max().item()
        return X * scale + torch.as_tensor(noise) + total + peak + jitter \
            + t0 + _host_norm(bg)

    return fn
