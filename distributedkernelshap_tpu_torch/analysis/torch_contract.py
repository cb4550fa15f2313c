"""Torch-contract lints (``DKS-J0xx``): the port's counterpart of the JAX
package's ``analysis/jax_contract.py``, under the same ids, so that pragmas
and ``docs/STATIC_ANALYSIS.md``'s catalog name the same hazards.

The engine's performance story rests on two contracts:

* **cache immutability**: the fingerprint-keyed ``_dev_cache`` /
  ``_plan_consts_cache`` entries (and every ``*_consts`` dict served from
  them) are shared by every later explain of the same content.  JAX
  guarded them by never donating them; eager torch has no donation, so the
  hazard becomes an in-place write (``add_``, ``copy_``, ``out=``, a kernel
  writing through ``.data_ptr()``) that silently poisons every later cache
  hit.
* **device-function purity**: the closures the ``build_*_fn`` builders
  return and the engine's per-call device entries run once per batch and
  are what a CUDA-graph capture takes (ROADMAP B, hot spot 3).  Host RNG
  and clock reads there bake one value into a captured graph, and a host
  sync (``.item()``, ``.cpu()``, ``float(tensor)``, ...) stalls the stream
  the explain was made sync-free for and breaks capture.

Checks:

* ``DKS-J001`` *unaudited-inplace* -- an in-place tensor method
  (:data:`INPLACE_METHODS`) or an ``out=`` argument writing into a
  parameter of the enclosing function (or of a function enclosing it) or
  into ``self.*`` state, through any chain of views, outside the audited
  :data:`INPLACE_ALLOWLIST`.  Writes into tensors the function allocated
  itself are not state and are out of scope.
* ``DKS-J002`` *cache-alias-write* -- the same kinds of write, or a
  tensor's ``.data_ptr()`` handed to a kernel launch as its output, on an
  expression derived from ``_dev_cache`` / ``_plan_consts_cache`` /
  ``*_consts`` state.  No allowlist: a cached constant is never written.
* ``DKS-J003`` *host-work-in-device-fn* -- host RNG (``np.random``,
  ``random``), a clock read, or a host sync (``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to('cpu')``, ``.synchronize()``, and
  ``float`` / ``int`` / ``bool`` of a tensor argument) inside a device
  function or anything it reaches by bare name in the same module.
* ``DKS-J004`` has no counterpart: eager torch has no static argnums, so
  there is no compile key for an unhashable default to break.

The fetch of a packed result (``ops/explain.fetch_transfer``), host plan
code and the dispatchers that call device functions and then copy to the
host stay outside :data:`DEVICE_ENTRIES` by construction, not by pragma.
"""

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from distributedkernelshap_tpu_torch.analysis.core import Finding

PKG = "distributedkernelshap_tpu_torch"

#: audited in-place write sites: (repo-relative path, enclosing function).
#: Each has been checked: it writes only state its caller hands over for
#: that purpose, never a cached constant.  The other in-place writes of the
#: package (``convert.cnn_from_numpy`` loading weights into the net it just
#: built, ``ops/cuda_kernels._exact_run`` zeroing the output it just
#: allocated) write fresh locals and are outside J001 by construction.
INPLACE_ALLOWLIST: Set[Tuple[str, str]] = {
    # initialises the weights of the freshly constructed net it is handed,
    # under no_grad, before the net is wrapped or trained
    (f"{PKG}/models/cnn.py", "_init_params"),
}

#: the package's device functions besides the closures of ``build_*_fn``
#: builders: the engine's per-call device entries and their exact-tree and
#: tensor-train peers (DeepSHAP and anytime rounds are builder closures)
DEVICE_ENTRIES: Set[Tuple[str, str]] = {
    (f"{PKG}/kernel_shap.py", "_linear_fast_call"),
    (f"{PKG}/kernel_shap.py", "_pack_fn"),
    (f"{PKG}/ops/treeshap.py", "exact_shap_from_reach"),
    (f"{PKG}/ops/treeshap.py", "exact_shap_and_interactions"),
    (f"{PKG}/ops/treeshap.py", "exact_shap_packed"),
    (f"{PKG}/ops/tensor_shap.py", "tensor_shap_phi"),
}

#: torch's in-place tensor methods that write a tensor's data
INPLACE_METHODS = {
    "abs_", "add_", "addcdiv_", "addcmul_", "addmm_", "baddbmm_", "clamp_",
    "clamp_max_", "clamp_min_", "copy_", "div_", "exp_", "fill_",
    "fill_diagonal_", "index_add_", "index_copy_", "index_fill_",
    "index_put_", "lerp_", "log_", "masked_fill_", "masked_scatter_", "mul_",
    "nan_to_num_", "neg_", "normal_", "pow_", "put_", "reciprocal_",
    "relu_", "resize_", "scatter_", "scatter_add_", "scatter_reduce_",
    "set_", "sigmoid_", "sqrt_", "sub_", "tanh_", "uniform_", "zero_",
}

#: methods whose result shares its receiver's storage: a write through the
#: result writes the receiver
VIEW_METHODS = {
    "as_strided", "chunk", "detach", "diagonal", "expand", "expand_as",
    "flatten", "movedim", "narrow", "permute", "select", "split", "squeeze",
    "t", "transpose", "unbind", "unflatten", "unfold", "unsqueeze", "view",
    "view_as",
}

#: attributes that are host metadata, not tensor data
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "size", "numel", "dim", "element_size",
               "nbytes", "itemsize", "stride", "is_contiguous"}

#: expression text that marks cache-resident state (the reference's
#: ``_CACHE_NAME_RE``)
_CACHE_NAME_RE = re.compile(r"(?:^|[._])(?:consts|cache[sd]?|_dev_cache)"
                            r"(?:$|[._\[])|consts\b|_cache\b")
#: engine accessors that hand out ``_dev_cache`` entries under a name the
#: pattern does not show
_CACHE_GETTERS = {"_device_args"}

_CLOCK_CALLS = {"time", "monotonic", "perf_counter", "process_time",
                "time_ns", "monotonic_ns", "perf_counter_ns"}
#: methods that wait for the device and copy to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SCALAR_CASTS = {"float", "int", "bool"}


def _is_cache_name(text: str) -> bool:
    return bool(_CACHE_NAME_RE.search(text)) or text in _CACHE_GETTERS


def _functions(tree: ast.Module):
    """``[(function node, chain of enclosing function nodes)]`` for every
    function of the module, outermost first in each chain."""

    out = []

    def visit(node, chain):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, chain))
                visit(child, chain + [child])
            else:
                visit(child, chain)

    visit(tree, [])
    return out


def _params(fn) -> Set[str]:
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names - {"self", "cls"}


def _base(expr: ast.AST) -> Tuple[Optional[str], bool]:
    """``(root name, through cache)`` of the storage ``expr`` writes into:
    attributes, subscripts, view methods and ``getattr`` are peeled to the
    root name; ``through cache`` records a cache-named attribute or
    accessor on the way.  ``(None, ...)`` for a freshly computed value."""

    via = False
    while True:
        if isinstance(expr, ast.Attribute):
            if expr.attr in _META_ATTRS:
                return None, via
            via = via or _is_cache_name(expr.attr)
            expr = expr.value
        elif isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Starred):
            expr = expr.value
        elif isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute) and f.attr in VIEW_METHODS:
                expr = f.value
            elif isinstance(f, ast.Attribute) and _is_cache_name(f.attr):
                via = True
                expr = f.value
            elif isinstance(f, ast.Name) and f.id == "getattr" and expr.args:
                expr = expr.args[0]
            else:
                return None, via
        elif isinstance(expr, ast.Name):
            return expr.id, via or _is_cache_name(expr.id)
        else:
            return None, via


class _Aliases:
    """What each local name aliases at a point of a function: ``'param'``
    (a parameter's storage), ``'self'`` (the object's state) or
    ``'cache'`` (cache-resident state), judged in source order."""

    def __init__(self, fn, chain):
        # a closure's captured builder parameters are caller state too
        self.kind: Dict[str, Set[str]] = {
            p: {"param"} for outer in chain + [fn] for p in _params(outer)}

    def of(self, expr: ast.AST) -> Set[str]:
        root, via = _base(expr)
        kinds: Set[str] = {"cache"} if via else set()
        if root == "self":
            kinds.add("self")
        elif root is not None:
            kinds |= self.kind.get(root, set())
        return kinds

    def bind(self, target: ast.AST, kinds: Set[str]) -> None:
        if isinstance(target, ast.Name):
            if kinds:
                self.kind[target.id] = set(kinds)
            else:
                self.kind.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.bind(elt, kinds)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, kinds)


def _own_nodes(fn):
    """The nodes of ``fn``'s body, without those of functions nested in it
    (each nested function is judged on its own)."""

    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                stack.append(child)


def _writes(fn) -> List[Tuple[ast.AST, str, ast.AST]]:
    """``[(site node, description, written expression)]`` in ``fn``'s own
    body: in-place methods, ``out=`` arguments and the output pointer of a
    kernel launch (the last ``.data_ptr()`` argument of a ``*_launch``
    call: every C entry of ``csrc/`` takes its output after its inputs)."""

    out = []
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in INPLACE_METHODS:
            out.append((node, f"`.{f.attr}()`", f.value))
        for kw in node.keywords:
            if kw.arg == "out":
                out.append((node, "`out=`", kw.value))
        callee = ast.unparse(f)
        if "_launch" in callee:
            ptrs = [a for a in node.args
                    if isinstance(a, ast.Call)
                    and isinstance(a.func, ast.Attribute)
                    and a.func.attr == "data_ptr"]
            if ptrs:
                out.append((node, "the output `.data_ptr()` of a kernel "
                                  "launch", ptrs[-1].func.value))
    return out


def _events(fn):
    """Bindings (assignments, ``for`` targets) and calls of ``fn``'s own
    body in evaluation order: by end position, a call before the binding
    that contains it (the right side runs before the target binds)."""

    events = []
    for node in _own_nodes(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                node.value is not None:
            events.append(((node.end_lineno, node.end_col_offset), 1, node))
        elif isinstance(node, ast.For):
            it = node.iter
            events.append(((it.end_lineno, it.end_col_offset), 1, node))
        elif isinstance(node, ast.Call):
            events.append(((node.end_lineno, node.end_col_offset), 0, node))
    events.sort(key=lambda e: (e[0], e[1]))
    return events


def check_inplace(tree: ast.Module, path: str,
                  allowlist: Optional[Set[Tuple[str, str]]] = None
                  ) -> List[Finding]:
    """DKS-J001 and DKS-J002.  ``allowlist`` defaults to the audited
    :data:`INPLACE_ALLOWLIST` (tests inject their own)."""

    if allowlist is None:
        allowlist = INPLACE_ALLOWLIST
    findings: List[Finding] = []
    for fn, chain in _functions(tree):
        by_node: Dict[int, List[Tuple[str, ast.AST]]] = {}
        for node, desc, expr in _writes(fn):
            by_node.setdefault(id(node), []).append((desc, expr))
        if not by_node:
            continue
        aliases = _Aliases(fn, chain)
        for _, kind, node in _events(fn):
            if kind == 1:
                if isinstance(node, ast.For):
                    aliases.bind(node.target, aliases.of(node.iter))
                else:
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    kinds = aliases.of(node.value)
                    for t in targets:
                        aliases.bind(t, kinds)
                continue
            for desc, expr in by_node.get(id(node), ()):
                kinds = aliases.of(expr)
                text = ast.unparse(expr)
                if "cache" in kinds:
                    findings.append(Finding(
                        "DKS-J002", path, node.lineno, fn.name,
                        f"{desc} writes `{text}` in `{fn.name}` -- "
                        f"cache-resident state; the write poisons every "
                        f"later hit of the fingerprint-keyed entry",
                        "write into a per-call tensor (clone the cached "
                        "constant first, or allocate the output fresh)"))
                elif kinds & {"param", "self"} and \
                        (path, fn.name) not in allowlist:
                    owner = "`self` state" if "self" in kinds else \
                        "a parameter's storage"
                    findings.append(Finding(
                        "DKS-J001", path, node.lineno, fn.name,
                        f"{desc} writes `{text}` in `{fn.name}` -- "
                        f"{owner}, outside the audited in-place allowlist "
                        f"(analysis/torch_contract.py)",
                        "write into a tensor the function allocates, or "
                        "audit the callers (no cached constant may reach "
                        "it) and add the site to INPLACE_ALLOWLIST"))
    return findings


def _device_roots(tree: ast.Module, path: str) -> List[ast.FunctionDef]:
    """The module's device functions: every function nested in a
    ``build_*_fn`` builder (the closures it returns) and the
    :data:`DEVICE_ENTRIES` of this path."""

    roots = []
    for fn, chain in _functions(tree):
        if any(o.name.startswith("build_") and o.name.endswith("_fn")
               for o in chain):
            roots.append(fn)
        elif (path, fn.name) in DEVICE_ENTRIES:
            roots.append(fn)
    return roots


def check_device_purity(tree: ast.Module, path: str) -> List[Finding]:
    """DKS-J003: the device roots and every module-level function they
    reach by bare name."""

    module_fns: Dict[str, List[ast.FunctionDef]] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_fns.setdefault(node.name, []).append(node)
    roots = _device_roots(tree, path)
    if not roots:
        return []
    checked: Dict[int, Tuple[ast.FunctionDef, bool]] = {
        id(fn): (fn, True) for fn in roots}
    frontier = list(roots)
    while frontier:
        fn = frontier.pop()
        for node in _own_nodes(fn):
            if isinstance(node, ast.Name) and node.id in module_fns:
                for callee in module_fns[node.id]:
                    if id(callee) not in checked:
                        checked[id(callee)] = (callee, False)
                        frontier.append(callee)
    findings: List[Finding] = []
    for fn, is_root in sorted(checked.values(), key=lambda v: v[0].lineno):
        findings.extend(_check_purity_in_fn(fn, path, tainted_params=is_root))
    return findings


def _tensor_names(fn) -> Set[str]:
    """A device root's parameters and the locals computed from them: the
    names that hold tensors (shape reads excluded)."""

    tainted = _params(fn)
    changed = True
    while changed:
        changed = False
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign):
                if _data_names(node.value) & tainted:
                    for n in _bound_names(node.targets):
                        if n not in tainted:
                            tainted.add(n)
                            changed = True
    return tainted


def _bound_names(targets) -> Set[str]:
    """The names an assignment binds (not those inside an attribute or
    subscript target, which it only reads)."""

    out: Set[str] = set()
    for t in targets:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out |= _bound_names(t.elts)
        elif isinstance(t, ast.Starred):
            out |= _bound_names([t.value])
    return out


def _data_names(expr: ast.AST) -> Set[str]:
    """Names whose tensor DATA ``expr`` reads: a name read only through a
    metadata attribute (``x.shape[0]``, ``x.ndim``) or ``len()`` does not
    count."""

    skip: Set[int] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
            skip.update(id(n) for n in ast.walk(node.value))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "len":
            skip.update(id(n) for a in node.args for n in ast.walk(a))
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and id(n) not in skip}


def _check_purity_in_fn(fn, path: str, tainted_params: bool
                        ) -> List[Finding]:
    findings: List[Finding] = []
    tensors = _tensor_names(fn) if tainted_params else set()

    def hit(node, what, why, hint):
        findings.append(Finding(
            "DKS-J003", path, node.lineno, fn.name,
            f"{what} inside device function `{fn.name}` -- {why}", hint))

    for node in _own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            base, attr = f.value.id, f.attr
            if base == "time" and attr in _CLOCK_CALLS:
                hit(node, f"host clock read `time.{attr}()`",
                    "a captured graph replays one reading",
                    "read the clock in the dispatcher around the call")
                continue
            if base == "random":
                hit(node, f"Python RNG call `random.{attr}()`",
                    "a captured graph replays one draw",
                    "draw on the device with a torch.Generator passed in, "
                    "or draw on the host before the call")
                continue
        if isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Attribute) and \
                isinstance(f.value.value, ast.Name) and \
                f.value.value.id in ("np", "numpy") and \
                f.value.attr == "random":
            hit(node, f"host RNG call `np.random.{f.attr}()`",
                "a captured graph replays one draw",
                "draw on the host before the call and pass the result in")
            continue
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            hit(node, f"host sync `.{f.attr}()`",
                "it waits for the device and breaks CUDA-graph capture",
                "keep the value on the device; fetch once in the "
                "dispatcher's finalize")
            continue
        if isinstance(f, ast.Attribute) and f.attr == "to" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "cpu":
            hit(node, "host copy `.to('cpu')`",
                "it waits for the device and breaks CUDA-graph capture",
                "keep the value on the device; fetch once in the "
                "dispatcher's finalize")
            continue
        if isinstance(f, ast.Name) and f.id in _SCALAR_CASTS and \
                len(node.args) == 1 and \
                _data_names(node.args[0]) & tensors:
            hit(node, f"host sync `{f.id}(<tensor>)`",
                "reading a tensor's value on the host waits for the device",
                "branch on the device (torch.where) or pass the host "
                "value in")
    return findings


def check_module(tree: ast.Module, path: str) -> List[Finding]:
    """All torch-contract findings for one parsed module."""

    findings = check_inplace(tree, path) + check_device_purity(tree, path)
    return sorted(findings, key=lambda f: (f.line, f.check_id, f.message))
