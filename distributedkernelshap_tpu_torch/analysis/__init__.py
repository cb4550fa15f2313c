"""Static analysis and the runtime lock witness of the PyTorch port (port of
``distributedkernelshap_tpu/analysis/``), run over the port's own sources.

Three stdlib-``ast`` analyzer families:

* **concurrency** (``DKS-C0xx``, :mod:`.concurrency`) — shared-attribute
  races, unlocked container iteration, lock-order cycles, blocking calls
  under a lock, unguarded thread loops;
* **torch contract** (``DKS-J0xx``, :mod:`.torch_contract`) — unaudited
  in-place writes into caller or object state, writes into cache-resident
  constants, host RNG / clock / syncs inside device functions (``DKS-J004``
  has no counterpart: eager torch has no static argnums);
* **serving ladder** (``DKS-L0xx``, :mod:`.ladder`) — every
  ``registry/classify.ENGINE_PATHS`` entry carries its full serving rung:
  dispatch entry, fingerprint-keyed consts cache, path-label site,
  fallback counter family, warmup signature wiring.

:mod:`.core` holds the finding record, pragma and baseline plumbing;
:mod:`.driver` the one lint entry point (``lint_repo``), with the port's
own ``baseline.toml``.  :mod:`.lockwitness` is a TSan-lite runtime witness
over the named control-plane locks (opt-in via ``DKS_LOCK_WITNESS=1``).

CLI and unified gate: ``scripts/torch_lint.py [--check]``.
"""

# Deliberately import-light: production modules import
# `analysis.lockwitness` for their named locks, so this package __init__
# must not drag the ast-based analyzer modules into the serving path.
# The driver API lives at `analysis.driver.lint_repo`.
from distributedkernelshap_tpu_torch.analysis import lockwitness  # noqa: F401
