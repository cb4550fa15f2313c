"""ctypes bindings for the native host-side kernels (see ``masked_eval.cc``).

Copy of ``distributedkernelshap_tpu/runtime/native.py`` for the port: the
black-box (host-eval) path's OpenMP fill of the synthetic rows and the
weighted mean of the predictor's outputs.  This is host code; it stands in
for no device work.

The library is built on first use with ``g++ -O3 -shared -fPIC -fopenmp
-march=native`` into ``build/native/``, named by a digest of the source and
the flags and written through a temporary file and ``os.replace``, so
processes building at once never load a half-written file and an edited
source never loads a stale library.  Where ``g++`` fails every entry point
keeps the reference's numpy route; :func:`fill_route` says which one runs.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from distributedkernelshap_tpu_torch.runtime.compile_cache import compile_events
from distributedkernelshap_tpu_torch.utils import REPO_ROOT

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "masked_eval.cc"
BUILD_DIR = Path(REPO_ROOT) / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-march=native")

_lock = threading.Lock()
_lib = None
_tried = False


def set_build_dir(path) -> None:
    """Build and load the library under ``path`` from now on
    (``runtime/compile_cache.enable_persistent_cache``)."""

    global BUILD_DIR
    BUILD_DIR = Path(path)


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdksruntime-{h.hexdigest()[:12]}.so"


def _build(path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native runtime build failed (%s); using the numpy route", e)
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""

    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        t0 = time.perf_counter()
        path = library_path()
        kind = "cache_hit" if path.exists() else "fresh"
        with compile_events().span(kind, "libdksruntime"):
            if kind == "fresh" and not _build(path):
                return None
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                logger.info("native runtime load failed (%s); using the numpy route", e)
                return None
        f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        lib.dks_masked_fill.argtypes = [f32p, f32p, f32p, f32p] + [ctypes.c_int64] * 4
        lib.dks_masked_fill.restype = None
        lib.dks_weighted_mean.argtypes = [f32p, f32p, f32p] + [ctypes.c_int64] * 3
        lib.dks_weighted_mean.restype = None
        _lib = lib
        compile_events().record(kind, time.perf_counter() - t0, "libdksruntime")
        logger.info("native runtime loaded: %s", path)
        return _lib


def fill_route() -> str:
    """``'native'`` when the OpenMP library is loaded, else ``'numpy'``."""

    return "native" if get_lib() is not None else "numpy"


def masked_fill(X: np.ndarray, bg: np.ndarray, zc: np.ndarray,
                out: np.ndarray = None) -> np.ndarray:
    """``out[b,s,n,:] = X[b]*zc[s] + bg[n]*(1-zc[s])`` flattened to rows."""

    B, D = X.shape
    N = bg.shape[0]
    S = zc.shape[0]
    if out is None:
        out = np.empty((B * S * N, D), dtype=np.float32)
    lib = get_lib()
    if lib is not None:
        lib.dks_masked_fill(np.ascontiguousarray(X, np.float32),
                            np.ascontiguousarray(bg, np.float32),
                            np.ascontiguousarray(zc, np.float32),
                            out, B, S, N, D)
        return out
    masked = (X[:, None, None, :] * zc[None, :, None, :]
              + bg[None, None, :, :] * (1.0 - zc[None, :, None, :]))
    np.copyto(out, masked.reshape(-1, D).astype(np.float32, copy=False))
    return out


def weighted_mean(pred: np.ndarray, w: np.ndarray, R: int) -> np.ndarray:
    """``ey[r] = Σ_n w[n]·pred[r·N+n]`` for row-major blocks of N rows."""

    N = w.shape[0]
    K = pred.shape[1]
    if pred.shape[0] != R * N:
        raise ValueError(
            f"predictor returned {pred.shape[0]} rows for {R * N} inputs "
            f"(R={R}, N={N}); black-box predictors must preserve row count")
    ey = np.empty((R, K), dtype=np.float32)
    lib = get_lib()
    if lib is not None:
        lib.dks_weighted_mean(np.ascontiguousarray(pred, np.float32),
                              np.ascontiguousarray(w, np.float32), ey, R, N, K)
        return ey
    return np.einsum("rnk,n->rk", pred.reshape(R, N, K), w).astype(np.float32)
