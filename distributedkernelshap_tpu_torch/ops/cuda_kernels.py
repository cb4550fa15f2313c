"""Hand-written CUDA kernels of the PyTorch port, their wrappers, their build,
and the plain PyTorch version of each.

``fused_linear_ey`` replaces the TPU kernel
``distributedkernelshap_tpu/ops/pallas_kernels.py:fused_linear_ey``: the
masked-evaluation reduction

    ey[b,s,k] = Σ_n bgw[n] · act(p1[b,s,k] + bgW[n,k] − t2[s,n,k])

of the linear fast path.  ``exact_tree_phi`` replaces
``pallas_kernels.py:exact_tree_phi``: the exact-TreeSHAP main-effect
contraction (see :func:`exact_tree_phi_plain`).  ``exact_tree_inter``
replaces ``pallas_kernels.py:exact_tree_inter``: the raw pairwise
Shapley-interaction sum of the same inputs (see
:func:`exact_tree_inter_plain`).  These are all the TPU kernels of the JAX
package.  Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at first use (the two exact kernels
share their packing, staging, live-row masks, tile sum and launch sequence
through ``csrc/exact_tree_common.cuh``, and read the division-free weight
tables :func:`build_weight_tables` makes) and bound through a plain C
interface with ``ctypes`` (nothing here compiles or imports CUDA code when
the module is imported).

A wrapper runs its kernel for CUDA tensors and raises when it cannot —
there is no fallback.  Only a tensor that lies on the CPU takes the plain
version (:func:`fused_linear_ey_plain`, :func:`exact_tree_phi_plain`,
:func:`exact_tree_inter_plain`), which is also what ``chip_smoke.py`` holds
each kernel against on the card.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

from distributedkernelshap_tpu_torch.models.predictors import ACTIVATIONS
from distributedkernelshap_tpu_torch.runtime.compile_cache import compile_events
from distributedkernelshap_tpu_torch.utils import REPO_ROOT

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(REPO_ROOT) / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: every kernel source of the port (``csrc/<name>.cu``)
KERNELS = ("fused_linear_ey", "exact_tree_phi", "exact_tree_inter")
#: widest class axis the kernel's register tiles take (``kMaxK`` in the .cu)
MAX_K = 32
#: most feature groups exact_tree_phi and exact_tree_inter take: one 64-bit
#: word per (background row, path) holds the M z_ok bits and the z_dead bit
#: (``kMaxM`` in each .cu)
MAX_TREE_M = 63
#: background rows the exact kernels stage per chunk, one bit of a lane's
#: live-row mask each (``kNC`` in ``csrc/exact_tree_common.cuh``)
EXACT_CHUNK_ROWS = 64

_VOID, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: per kernel library: its C symbols as ``name: (argtypes, restype)``, and
#: the limit function the wrapper's constant must agree with
_SYMBOLS = {
    "fused_linear_ey": {
        "fused_linear_ey_launch": ([_VOID] * 6 + [_INT] * 6 + [_VOID], _INT),
        "fused_linear_ey_max_k": ([], _INT),
        "fused_linear_ey_launch_info": ([_INT] * 5 + [_VOID], _INT),
    },
    "exact_tree_phi": {
        "exact_tree_phi_launch": ([_VOID] * 10 + [_INT] * 6 + [_VOID], _INT),
        "exact_tree_phi_partial_tiles": ([_INT], _INT),
        "exact_tree_phi_max_m": ([], _INT),
        "exact_tree_phi_smem_bytes": ([_INT], _LONG),
        "exact_tree_phi_blocks_per_sm": ([_INT], _INT),
    },
    "exact_tree_inter": {
        "exact_tree_inter_launch": ([_VOID] * 10 + [_INT] * 6 + [_VOID], _INT),
        "exact_tree_inter_partial_tiles": ([_INT], _INT),
        "exact_tree_inter_max_m": ([], _INT),
        "exact_tree_inter_smem_bytes": ([_INT], _LONG),
        "exact_tree_inter_blocks_per_sm": ([_INT], _INT),
    },
}
_LIMITS = {"fused_linear_ey": ("fused_linear_ey_max_k", MAX_K),
           "exact_tree_phi": ("exact_tree_phi_max_m", MAX_TREE_M),
           "exact_tree_inter": ("exact_tree_inter_max_m", MAX_TREE_M)}

_ACTIVATION_CODE = {"softmax": 0, "sigmoid": 1}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: kernels whose library this process compiled (their load is no cache hit)
_built_here = set()


def set_build_dir(path) -> None:
    """Build and load kernel libraries under ``path`` from now on
    (``runtime/compile_cache.enable_persistent_cache``)."""

    global BUILD_DIR
    BUILD_DIR = Path(path)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a digest of the source,
    the shared headers and the flags, so an edited source never loads a
    stale library."""

    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel source that is not built yet, one ``nvcc``
    per source, all started together.  The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) lands beside each library as
    ``<library>.log``.  Raises on any failed build."""

    out = {name: library_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        path = todo[name]
        path.with_name(path.name + ".log").write_text(log)
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
            _built_here.add(name)
            compile_events().record("fresh", time.perf_counter() - t0, name)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def _library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, binding its symbols
    from ``_SYMBOLS`` and checking its limit against the wrapper's."""

    with _lock:
        if name not in _libs:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build([name])[name]))
            for sym, (argtypes, restype) in _SYMBOLS[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            limit_fn, limit = _LIMITS[name]
            if getattr(lib, limit_fn)() != limit:
                raise RuntimeError(f"csrc/{name}.cu and the wrapper's limit disagree")
            _libs[name] = lib
            if name not in _built_here:
                compile_events().record("cache_hit", time.perf_counter() - t0, name)
        return _libs[name]


def _check(XWg, bgWg, bgW, bgw, mask, activation: str):
    """Validate the wrapper's inputs; returns ``(B, S, N, M, K)``."""

    if activation == "identity":
        raise ValueError("identity never reaches fused_linear_ey: _ey_linear "
                         "collapses the background axis analytically")
    if activation not in _ACTIVATION_CODE:
        raise ValueError(f"activation must be softmax or sigmoid, got {activation!r}")
    args = {"XWg": XWg, "bgWg": bgWg, "bgW": bgW, "bgw": bgw, "mask": mask}
    for name, t in args.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != XWg.device:
            raise ValueError(f"{name} is on {t.device}, XWg on {XWg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if XWg.ndim != 3 or bgWg.ndim != 3 or bgW.ndim != 2 or bgw.ndim != 1 \
            or mask.ndim != 2:
        raise ValueError("expected XWg (B,M,K), bgWg (N,M,K), bgW (N,K), "
                         "bgw (N,), mask (S,M)")
    B, M, K = XWg.shape
    N, S = bgWg.shape[0], mask.shape[0]
    if tuple(bgWg.shape) != (N, M, K) or tuple(bgW.shape) != (N, K) \
            or tuple(bgw.shape) != (N,) or mask.shape[1] != M:
        raise ValueError(
            f"shape mismatch: XWg {tuple(XWg.shape)}, bgWg {tuple(bgWg.shape)}, "
            f"bgW {tuple(bgW.shape)}, bgw {tuple(bgw.shape)}, mask {tuple(mask.shape)}")
    return B, S, N, M, K


def fused_linear_ey(XWg: torch.Tensor, bgWg: torch.Tensor, bgW: torch.Tensor,
                    bgw: torch.Tensor, mask: torch.Tensor,
                    activation: str = "softmax") -> torch.Tensor:
    """Fused ``ey`` for a logits-linear predictor.

    ``XWg (B, M, K)`` per-group instance logits, ``bgWg (N, M, K)`` per-group
    background logits, ``bgW (N, K)`` full background logits (bias
    included), ``bgw (N,)`` background weights (normalised here: the binary
    softmax path needs Σ bgw = 1), ``mask (S, M)`` coalition masks; all
    contiguous float32 on one device.  Returns ``ey (B, S, K)``.

    CUDA tensors launch ``csrc/fused_linear_ey.cu`` (building it on first
    use) and count one in ``fused_linear_ey.launches``; a failed build or
    launch raises.  CPU tensors run :func:`fused_linear_ey_plain`."""

    B, S, N, M, K = _check(XWg, bgWg, bgW, bgw, mask, activation)
    if XWg.device.type == "cpu":
        return fused_linear_ey_plain(XWg, bgWg, bgW, bgw, mask, activation)
    if K > MAX_K:
        raise ValueError(
            f"the fused_linear_ey kernel takes at most {MAX_K} classes, got {K}; "
            "explain wider models with ShapConfig(use_kernel=False)")
    if XWg.device.type != "cuda":
        raise ValueError(f"fused_linear_ey runs on cuda or cpu, not {XWg.device}")
    lib = _library("fused_linear_ey")
    bgw = (bgw / bgw.sum()).contiguous()
    out = torch.empty((B, S, K), dtype=torch.float32, device=XWg.device)
    if B == 0 or S == 0:
        return out
    with torch.cuda.device(XWg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_linear_ey_launch(
            XWg.data_ptr(), bgWg.data_ptr(), bgW.data_ptr(), bgw.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, S, N, M, K,
            _ACTIVATION_CODE[activation], stream)
    if err:
        raise RuntimeError(f"fused_linear_ey launch failed with CUDA error {err}")
    fused_linear_ey.launches += 1
    return out


fused_linear_ey.launches = 0


def ey_launch_info(B: int, S: int, N: int, K: int,
                   activation: str = "softmax") -> Dict[str, int]:
    """What a :func:`fused_linear_ey` call at these sizes launches on the
    card: ``blocks``, ``threads`` a block, dynamic ``smem_bytes``, resident
    ``blocks_per_sm`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    ``registers`` and ``local_bytes`` a thread (``cudaFuncGetAttributes``)
    and background ``chunk_rows``.  Builds the kernel if needed; raises where
    the card refuses the query."""

    lib = _library("fused_linear_ey")
    info = (ctypes.c_int * 7)()
    err = lib.fused_linear_ey_launch_info(B, S, N, K, _ACTIVATION_CODE[activation],
                                          ctypes.addressof(info))
    if err:
        raise RuntimeError(f"fused_linear_ey launch info failed with CUDA error {err}")
    keys = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "registers",
            "local_bytes", "chunk_rows")
    return dict(zip(keys, info))


def ey_guard_constants() -> Dict[str, float]:
    """The guard of ``fused_linear_ey``'s factored sigmoid form, read from
    its source: ``spread``, the widest t' range of a chunk the factored
    route takes (``kSpread``), and ``clamp``, the bound on ``|dp − shift|``
    (``kClamp``).  Readable without a card."""

    src = (CSRC_DIR / "fused_linear_ey.cu").read_text()
    out = {}
    for key, name in (("spread", "kSpread"), ("clamp", "kClamp")):
        m = re.search(rf"constexpr float {name} = ([0-9.]+)f;", src)
        if not m:
            raise RuntimeError(f"csrc/fused_linear_ey.cu defines no {name}")
        out[key] = float(m.group(1))
    return out


def fused_linear_ey_plain(XWg: torch.Tensor, bgWg: torch.Tensor, bgW: torch.Tensor,
                          bgw: torch.Tensor, mask: torch.Tensor,
                          activation: str = "softmax",
                          chunk: Optional[int] = None) -> torch.Tensor:
    """:func:`fused_linear_ey` in plain PyTorch, on any device and for any
    number of classes: the same branches (the binary-softmax shortcut with
    k=0 as the complement), with the ``(B, c, N, K)`` logits tensor
    materialised ``chunk`` coalitions at a time (default: ``2**25`` elements
    a chunk).  The binary branch's largest intermediate is K-free, so it
    takes twice the rows per chunk."""

    B, S, N, M, K = _check(XWg, bgWg, bgW, bgw, mask, activation)
    bgw = bgw / bgw.sum()
    out = torch.empty((B, S, K), dtype=torch.float32, device=XWg.device)
    c = chunk or max(1, min(S, (1 << 25) // max(1, B * N * K)))
    if activation == "softmax" and K == 2:
        dX = XWg[:, :, 1] - XWg[:, :, 0]                 # (B, M)
        dbg = bgWg[:, :, 1] - bgWg[:, :, 0]              # (N, M)
        dW = bgW[:, 1] - bgW[:, 0]                       # (N,)
        for s0 in range(0, S, 2 * c):
            mc = mask[s0:s0 + 2 * c]
            dp = (mc @ dX.T).T                           # (B, c)
            dt2 = mc @ dbg.T - dW[None, :]               # (c, N)
            ey1 = torch.sigmoid(dp[:, :, None] - dt2[None]) @ bgw
            out[:, s0:s0 + 2 * c, 1] = ey1
            out[:, s0:s0 + 2 * c, 0] = 1.0 - ey1
        return out
    act = ACTIVATIONS[activation]
    for s0 in range(0, S, c):
        mc = mask[s0:s0 + c]
        p1 = torch.einsum("sm,bmk->bsk", mc, XWg)        # (B, c, K)
        t2 = torch.einsum("sm,nmk->snk", mc, bgWg)       # (c, N, K)
        logits = p1[:, :, None, :] + bgW[None, None] - t2[None]
        out[:, s0:s0 + c] = torch.einsum("bcnk,n->bck", act(logits), bgw)
    return out


# ---------------------------------------------------------------------- #
# exact_tree_phi: exact-TreeSHAP main effects


def _check_phi(x_only, x_not, z_ok, z_dead, leaf_val, bgw, dmax: int):
    """Validate :func:`exact_tree_phi`'s inputs; returns ``(B, P, N, M, K)``."""

    args = {"x_only": x_only, "x_not": x_not, "z_ok": z_ok, "z_dead": z_dead,
            "leaf_val": leaf_val, "bgw": bgw}
    for name, t in args.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x_only.device:
            raise ValueError(f"{name} is on {t.device}, x_only on {x_only.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x_only.ndim != 3 or z_ok.ndim != 3 or z_dead.ndim != 2 \
            or leaf_val.ndim != 2 or bgw.ndim != 1:
        raise ValueError("expected x_only/x_not (B,P,M), z_ok (N,P,M), "
                         "z_dead (N,P), leaf_val (P,K), bgw (N,)")
    B, P, M = x_only.shape
    N, K = z_ok.shape[0], leaf_val.shape[1]
    if tuple(x_not.shape) != (B, P, M) or tuple(z_ok.shape) != (N, P, M) \
            or tuple(z_dead.shape) != (N, P) or tuple(leaf_val.shape) != (P, K) \
            or tuple(bgw.shape) != (N,):
        raise ValueError(
            f"shape mismatch: x_only {tuple(x_only.shape)}, x_not "
            f"{tuple(x_not.shape)}, z_ok {tuple(z_ok.shape)}, z_dead "
            f"{tuple(z_dead.shape)}, leaf_val {tuple(leaf_val.shape)}, "
            f"bgw {tuple(bgw.shape)}")
    if int(dmax) < 1:
        raise ValueError(f"dmax must be >= 1, got {dmax}")
    return B, P, N, M, K


def exact_tree_phi(x_only: torch.Tensor, x_not: torch.Tensor, z_ok: torch.Tensor,
                   z_dead: torch.Tensor, leaf_val: torch.Tensor, bgw: torch.Tensor,
                   dmax: int) -> torch.Tensor:
    """Exact-TreeSHAP main effects ``phi (B, M, K)`` (see
    :func:`exact_tree_phi_plain` for the function and the layouts).

    ``x_only/x_not/z_ok/z_dead`` are 0/1 indicators (the kernel reads them
    as ``> 0.5``), ``bgw`` the normalised background weights and ``dmax``
    the bound on the conjunction counts.  CUDA tensors launch
    ``csrc/exact_tree_phi.cu`` (building it on first use) and count one in
    ``exact_tree_phi.launches``; the kernel takes any N, P, K and dmax and
    at most ``MAX_TREE_M`` groups, and above that it raises.  Two launches
    on the same inputs give bit-identical phi.  CPU tensors run the plain
    version."""

    B, P, N, M, K = _check_phi(x_only, x_not, z_ok, z_dead, leaf_val, bgw, dmax)
    if x_only.device.type == "cpu":
        return exact_tree_phi_plain(x_only, x_not, z_ok, z_dead, leaf_val, bgw, dmax)
    return _exact_launch(exact_tree_phi, (B, M, K),
                         (x_only, x_not, z_ok, z_dead, leaf_val, bgw), dmax)


exact_tree_phi.launches = 0


def _exact_launch(wrapper, out_shape, args, dmax: int) -> torch.Tensor:
    """Launch the kernel of ``wrapper`` (:func:`exact_tree_phi` or
    :func:`exact_tree_inter`, whose ``csrc/<name>.cu`` share their inputs and
    their C interface) on card tensors that :func:`_check_phi` passed, and
    return its output of ``out_shape``.  Raises above the group limit, off a
    CUDA device, and on a failed build or launch."""

    name, x_only = wrapper.__name__, args[0]
    M = x_only.shape[2]
    if M > MAX_TREE_M:
        raise ValueError(
            f"the {name} kernel takes at most {MAX_TREE_M} feature groups, "
            f"got {M}; explain wider groupings with ShapConfig(use_kernel=False)")
    if x_only.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x_only.device}")
    lib = _library(name)
    with torch.cuda.device(x_only.device):
        return _exact_run(wrapper, lib, torch.cuda.current_stream().cuda_stream,
                          out_shape, args, dmax)


def _exact_run(wrapper, lib, stream, out_shape, args, dmax: int) -> torch.Tensor:
    """Call the loaded kernel library ``lib`` of ``wrapper`` on ``stream``
    and count one in ``wrapper.launches`` once the launch succeeded.  A
    problem with a zero size launches nothing, counts nothing and returns
    zeros."""

    name, x_only = wrapper.__name__, args[0]
    B, P, M = x_only.shape
    N, K = args[2].shape[0], args[4].shape[1]
    dev = x_only.device
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    if 0 in (B, P, N, M, K):
        return out.zero_()
    dm = min(int(dmax), M)
    tables = exact_weight_tables(_TABLE_KIND[name], dm, M, dev)
    # scratch: the packed background bits and one partial output per path
    # tile (summed in a fixed order by a second pass)
    zbits = torch.empty((N, P), dtype=torch.int64, device=dev)
    partial = torch.empty((getattr(lib, f"{name}_partial_tiles")(P), *out_shape),
                          dtype=torch.float32, device=dev)
    err = getattr(lib, f"{name}_launch")(
        *(t.data_ptr() for t in args), tables.data_ptr(), zbits.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, P, N, M, K, dm, stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    wrapper.launches += 1
    return out


#: the weight tables each exact kernel reads (see :func:`build_weight_tables`)
_TABLE_KIND = {"exact_tree_phi": "phi", "exact_tree_inter": "inter"}
_tables: Dict[tuple, torch.Tensor] = {}


def build_weight_tables(kind: str, dmax: int, M: int) -> torch.Tensor:
    """The reciprocal weight tables of an exact kernel, on the CPU: float32
    ``(ntab, M+1, M+1)`` indexed ``[table, u, v]``, so a live row reads its
    weights and multiplies by ``bgw[n]`` instead of dividing.

    Each comes from the reference's masked-product binomial in float32 (the
    plain versions' arithmetic: steps ``i = 1..dmax`` of ``(v+i)/i``, taken
    while ``i <= u`` for phi's ``C(u+v, u)`` and ``i <= u-1`` for the
    pairs' ``C(u+v-1, v)``); the reciprocal is taken in float64 and rounded
    once.  ``kind="phi"``: ``wp = 1/(u·C)`` (u >= 1) and ``wm = 1/(v·C)``
    (v >= 1).  ``kind="inter"``: ``W_uu = 1/((u-1)·C)`` (u >= 2), ``W_uv =
    -1/(v·C)`` (u, v >= 1) and ``W_vv = u/(v(v-1)·C)`` (v >= 2, u >= 1),
    ``1/(v-1)`` at u = 0.  Zero elsewhere."""

    if kind not in ("phi", "inter"):
        raise ValueError(f"kind must be 'phi' or 'inter', got {kind!r}")
    dm = min(int(dmax), M)
    f = torch.arange(M + 1, dtype=torch.float32)
    u, v = f[:, None], f[None, :]
    steps = u if kind == "phi" else u - 1.0
    binom = torch.ones((M + 1, M + 1), dtype=torch.float32)
    for i in range(1, dm + 1):
        binom = binom * torch.where(steps + 0.5 >= i, (v + i) / i, 1.0)
    C, u, v = binom.double(), u.double(), v.double()
    zero = torch.zeros((), dtype=torch.float64)
    if kind == "phi":
        tabs = (torch.where(u >= 1, 1.0 / (u.clamp(min=1.0) * C), zero),
                torch.where(v >= 1, 1.0 / (v.clamp(min=1.0) * C), zero))
    else:
        vv = torch.where(u >= 1, u / (v * (v - 1.0)).clamp(min=1.0),
                         1.0 / (v - 1.0).clamp(min=1.0)) / C
        tabs = (torch.where(u >= 2, 1.0 / ((u - 1.0).clamp(min=1.0) * C), zero),
                torch.where((u >= 1) & (v >= 1), -1.0 / (v.clamp(min=1.0) * C), zero),
                torch.where(v >= 2, vv, zero))
    return torch.stack(tabs).to(torch.float32).contiguous()


def exact_weight_tables(kind: str, dmax: int, M: int,
                        device: torch.device) -> torch.Tensor:
    """:func:`build_weight_tables` on ``device``, built once per ``(kind,
    dmax, M, device)`` and cached."""

    key = (kind, min(int(dmax), M), M, str(device))
    with _lock:
        if key not in _tables:
            _tables[key] = build_weight_tables(kind, dmax, M).to(device)
        return _tables[key]


def tile_kernel_info(name: str, M: int) -> Dict[str, int]:
    """What the tile kernel of ``csrc/<name>.cu`` takes on the card at ``M``
    groups: its dynamic shared memory in bytes and its resident blocks per
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Builds the
    kernel if needed; raises where the card refuses the query."""

    lib = _library(name)
    info = {"smem_bytes": getattr(lib, f"{name}_smem_bytes")(M),
            "blocks_per_sm": getattr(lib, f"{name}_blocks_per_sm")(M)}
    if info["smem_bytes"] < 0 or info["blocks_per_sm"] < 0:
        raise RuntimeError(f"{name} at M={M}: occupancy query failed {info}")
    return info


def ptxas_report(log: str) -> List[Dict[str, object]]:
    """Per kernel function, what ``nvcc -Xptxas -v`` reported in a build
    log: ``{"function", "registers", "smem_bytes" (static), "stack_bytes",
    "spill_stores", "spill_loads"}``, in the log's order."""

    out: List[Dict[str, object]] = []
    cur: Optional[Dict[str, object]] = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def exact_tree_phi_plain(x_only: torch.Tensor, x_not: torch.Tensor,
                         z_ok: torch.Tensor, z_dead: torch.Tensor,
                         leaf_val: torch.Tensor, bgw: torch.Tensor, dmax: int,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """:func:`exact_tree_phi` in plain PyTorch, on any device.

    Per instance ``b``, path ``p`` and background row ``n``: the
    conjunction counts ``u = Σ_m x_only·(1-z_ok)``, ``v = Σ_m x_not·z_ok``
    and ``dead = Σ_m x_not·(1-z_ok)``; the row is alive when ``dead = 0``
    and ``z_dead = 0``; the binomial ``C(u+v, u)`` as the reference's
    ``dmax``-step masked product ``Π_{i<=u} (v+i)/i``; ``a = bgw/binom``,
    the Beta weights ``wp = a/u`` and ``wm = a/v``; then
    ``s_p = Σ_n wp·(1-z_ok)``, ``s_m = Σ_n wm·z_ok`` and
    ``phi[b,m,k] = Σ_p (s_p·x_only − s_m·x_not)[b,p,m] · leaf_val[p,k]``.

    Layouts as the JAX function's: ``x_only/x_not (B,P,M)``, ``z_ok
    (N,P,M)``, ``z_dead (N,P)``, ``leaf_val (P,K)``, ``bgw (N,)``.  The
    background is processed ``chunk`` rows at a time (default: ``(B,
    chunk, P)`` intermediates of at most ``2**23`` elements)."""

    B, P, N, M, K = _check_phi(x_only, x_not, z_ok, z_dead, leaf_val, bgw, dmax)
    # steps past M multiply by exactly 1 (u <= M): the clamp is exact
    dm = min(int(dmax), M)
    c = chunk or max(1, min(N, (1 << 23) // max(1, B * P)))
    s_p = torch.zeros((B, P, M), dtype=torch.float32, device=x_only.device)
    s_m = torch.zeros_like(s_p)
    for n0 in range(0, N, c):
        z = z_ok[n0:n0 + c]
        nz = 1.0 - z
        u = torch.einsum("bpm,npm->bnp", x_only, nz)
        v = torch.einsum("bpm,npm->bnp", x_not, z)
        dead = torch.einsum("bpm,npm->bnp", x_not, nz)
        alive = (dead < 0.5) & (z_dead[None, n0:n0 + c] < 0.5)
        binom = torch.ones_like(u)
        for i in range(1, dm + 1):
            binom = binom * torch.where(u + 0.5 >= i, (v + i) / i, 1.0)
        a = torch.where(alive, bgw[None, n0:n0 + c, None] / binom, 0.0)
        wp = torch.where(u > 0.5, a / u.clamp(min=1.0), 0.0)
        wm = torch.where(v > 0.5, a / v.clamp(min=1.0), 0.0)
        s_p += torch.einsum("bnp,npm->bpm", wp, nz)
        s_m += torch.einsum("bnp,npm->bpm", wm, z)
    d = s_p * x_only - s_m * x_not
    return torch.einsum("bpm,pk->bmk", d, leaf_val)


# ---------------------------------------------------------------------- #
# exact_tree_inter: exact pairwise Shapley interactions


def exact_tree_inter(x_only: torch.Tensor, x_not: torch.Tensor, z_ok: torch.Tensor,
                     z_dead: torch.Tensor, leaf_val: torch.Tensor, bgw: torch.Tensor,
                     dmax: int) -> torch.Tensor:
    """Raw pairwise Shapley-interaction sum ``inter (B, M, M, K)``
    (``[b, g, h, k]``, diagonal included; see :func:`exact_tree_inter_plain`)
    of :func:`exact_tree_phi`'s inputs.

    CUDA tensors launch ``csrc/exact_tree_inter.cu`` (building it on first
    use) and count one in ``exact_tree_inter.launches``; the kernel takes any
    N, P, K and dmax and at most ``MAX_TREE_M`` groups, and above that it
    raises.  Two launches on the same inputs give bit-identical output.  CPU
    tensors run the plain version."""

    B, P, N, M, K = _check_phi(x_only, x_not, z_ok, z_dead, leaf_val, bgw, dmax)
    if x_only.device.type == "cpu":
        return exact_tree_inter_plain(x_only, x_not, z_ok, z_dead, leaf_val, bgw, dmax)
    return _exact_launch(exact_tree_inter, (B, M, M, K),
                         (x_only, x_not, z_ok, z_dead, leaf_val, bgw), dmax)


exact_tree_inter.launches = 0


def exact_tree_inter_plain(x_only: torch.Tensor, x_not: torch.Tensor,
                           z_ok: torch.Tensor, z_dead: torch.Tensor,
                           leaf_val: torch.Tensor, bgw: torch.Tensor, dmax: int,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """:func:`exact_tree_inter` in plain PyTorch, on any device.

    Per instance ``b``, path ``p`` and background row ``n``: the counts
    ``u``, ``v``, ``dead`` and the alive gate as in
    :func:`exact_tree_phi_plain`; ONE binomial ``C(u+v-1, v)`` as the
    reference's ``dmax``-step masked product ``Π_{i<=u-1} (v+i)/i``;
    ``base = bgw/C`` on alive rows and the pairwise Beta weights

        W_uu = base/(u-1)        (u >= 2)
        W_uv = -base/v           (u, v >= 1)
        W_vv = base·u/(v(v-1))   (v >= 2, u >= 1);  base·(1/(v-1)) at u = 0.

    Then for each group ``g``, with ``ag = x_only[g]·(1-z_ok[g])`` (g in U)
    and ``cg = x_not[g]·z_ok[g]`` (g in V): ``w_p = W_uu·ag + W_uv·cg``
    pairs with ``(x_only, 1-z_ok)``, ``w_m = W_vv·cg + W_uv·ag`` with
    ``(x_not, z_ok)``, and ``inter[b,g,h,k] = Σ_p (s_p·x_only +
    s_m·x_not)[b,p,h]·leaf_val[p,k]`` over ``s_p = Σ_n w_p·(1-z_ok)``,
    ``s_m = Σ_n w_m·z_ok``.  The diagonal ``g = h`` is included, as the TPU
    kernel returns it.

    Layouts as :func:`exact_tree_phi_plain`'s; returns ``(B, M, M, K)``.
    The background is processed ``chunk`` rows at a time (default: ``(B,
    chunk, P)`` intermediates of at most ``2**23`` elements) and g in an
    outer loop, so no ``(B, P, M, M)`` tensor is built."""

    B, P, N, M, K = _check_phi(x_only, x_not, z_ok, z_dead, leaf_val, bgw, dmax)
    # steps past M multiply by exactly 1 (u - 1 < M): the clamp is exact
    dm = min(int(dmax), M)
    c = chunk or max(1, min(N, (1 << 23) // max(1, B * P)))
    out = torch.zeros((B, M, M, K), dtype=torch.float32, device=x_only.device)
    for n0 in range(0, N, c):
        z = z_ok[n0:n0 + c]
        nz = 1.0 - z
        u = torch.einsum("bpm,npm->bnp", x_only, nz)
        v = torch.einsum("bpm,npm->bnp", x_not, z)
        dead = torch.einsum("bpm,npm->bnp", x_not, nz)
        alive = (dead < 0.5) & (z_dead[None, n0:n0 + c] < 0.5)
        binom = torch.ones_like(u)
        for i in range(1, dm + 1):
            binom = binom * torch.where(u - 0.5 >= i, (v + i) / i, 1.0)
        base = torch.where(alive, bgw[None, n0:n0 + c, None] / binom, 0.0)
        w_uu = torch.where(u > 1.5, base / (u - 1.0).clamp(min=1.0), 0.0)
        w_uv = -torch.where((u > 0.5) & (v > 0.5), base / v.clamp(min=1.0), 0.0)
        w_vv = torch.where(v > 1.5, base * torch.where(
            u > 0.5, u / (v * (v - 1.0)).clamp(min=1.0),
            1.0 / (v - 1.0).clamp(min=1.0)), 0.0)
        for g in range(M):
            ag = x_only[:, None, :, g] * nz[None, :, :, g]    # (B, c, P)
            cg = x_not[:, None, :, g] * z[None, :, :, g]
            w_p = w_uu * ag + w_uv * cg
            w_m = w_vv * cg + w_uv * ag
            d = (torch.einsum("bnp,npm->bpm", w_p, nz) * x_only
                 + torch.einsum("bnp,npm->bpm", w_m, z) * x_not)
            out[:, g] += torch.einsum("bpm,pk->bmk", d, leaf_val)
    return out
