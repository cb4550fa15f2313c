"""Concurrency lints (``DKS-C0xx``): an attribute-access model over
classes that spawn threads.

The model, per class:

* **lock attributes** — ``self._lock = threading.Lock()`` / ``RLock`` /
  ``Condition`` / the lockwitness factories (``make_lock`` etc.) or a
  ``lock or threading.Lock()`` parameter default.
* **thread entries** — methods passed as ``threading.Thread(target=...)``
  or into an executor's ``submit``/``map``; everything reachable from
  them through in-class calls (including bare ``self.m`` callback
  references) is *thread context*.
* **accesses** — every ``self.attr`` read / assignment / ``+=`` /
  mutating container-method call / subscript store / iteration, tagged
  with whether it happens inside a ``with self._lock`` region.  Private
  methods whose every in-class call site is lock-held are *locked
  context* (the ``_fill_grouped`` pattern: "caller holds the lock") and
  their accesses count as locked.
* **init context** — ``__init__`` plus private helpers called only from
  it (``_attach_metrics``); construction-time stores are configuration,
  not racing mutation.

Checks:

* ``DKS-C001`` *unlocked-shared-write* — an attribute mutated without
  the lock where thread-context code and non-thread code both touch it.
* ``DKS-C002`` *unlocked-iteration* — iterating (or bulk-copying) a
  dict/deque/set/list attribute outside the lock while another method
  mutates it ("dictionary changed size during iteration" in production).
* ``DKS-C003`` *lock-order-cycle* — the class's cross-method lock
  acquisition graph has a cycle (deadlock hazard).
* ``DKS-C004`` *blocking-under-lock* — socket/HTTP reads, untimed
  ``queue.get``/``put``, subprocess waits or sleeps while holding a
  lock that request/scheduler/panel threads contend on.
* ``DKS-C005`` *unguarded-thread-loop* — a long-lived thread loop whose
  body can die on the first exception ("the batcher thread died and
  batch formation stopped").

Every check is deliberately conservative: it fires only where the class
itself signals concurrent use (spawns threads and/or owns a lock), so
single-threaded value classes stay silent.
"""

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from distributedkernelshap_tpu_torch.analysis.core import Finding

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
WITNESS_FACTORIES = {"make_lock", "make_rlock", "make_condition"}
#: attribute value types whose own methods are thread-safe (or which are
#: synchronisation primitives themselves) — mutations through them are
#: not findings
SAFE_FACTORIES = {"Lock", "RLock", "Condition", "Event", "Semaphore",
                  "BoundedSemaphore", "Barrier", "Queue", "LifoQueue",
                  "PriorityQueue", "SimpleQueue", "Thread", "local",
                  "ThreadPoolExecutor", "ProcessPoolExecutor",
                  "StagingBuffer", "flightrec"}
CONTAINER_FACTORIES = {"dict", "list", "set", "OrderedDict", "deque",
                       "defaultdict", "Counter"}
#: containers whose iteration RAISES when a mutator interleaves
#: ("dictionary changed size during iteration") — the C002 universe;
#: list iteration under concurrent append is CPython-tolerated and a
#: lower-severity pattern the repo uses deliberately (append-only
#: replica rosters)
RAISING_CONTAINERS = {"dict", "set", "OrderedDict", "deque",
                      "defaultdict", "Counter"}
#: in-place mutation kinds; a plain rebind (`self.x = new_list`) is
#: copy-on-write — iterators over the OLD object stay valid
INPLACE_KINDS = {"aug", "mutcall", "subwrite", "delete"}
MUTATOR_METHODS = {"append", "appendleft", "add", "discard", "remove",
                   "pop", "popleft", "popitem", "clear", "update",
                   "extend", "insert", "setdefault", "move_to_end",
                   "rotate", "sort"}
#: calls that bulk-read (iterate) their container argument
SNAPSHOT_CALLS = {"list", "tuple", "set", "frozenset", "sorted", "dict",
                  "sum", "min", "max", "any", "all", "enumerate",
                  "reversed", "map", "filter"}
MUTATION_KINDS = {"write", "aug", "mutcall", "subwrite", "delete"}
#: blocking call names on arbitrary receivers (sockets, HTTP conns,
#: subprocess pipes)
BLOCKING_ATTR_CALLS = {"recv", "recvfrom", "accept", "sendall",
                       "getresponse", "communicate"}
BLOCKING_SUBPROCESS_FUNCS = {"run", "call", "check_call", "check_output"}


@dataclass
class Access:
    method: str
    kind: str       # read | write | aug | mutcall | subwrite | delete | iterate
    line: int
    locked: bool


@dataclass
class BlockSite:
    method: str
    line: int
    desc: str
    locked: bool
    lock_name: str


def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _infer_factory(value: ast.AST) -> Optional[str]:
    """The factory name behind an ``__init__`` assignment value —
    ``threading.Lock()`` -> ``Lock``, ``{}`` -> ``dict``, ``lock or
    threading.Lock()`` -> ``Lock``, ``OrderedDict()`` -> ``OrderedDict``."""

    if isinstance(value, ast.Call):
        return _call_name(value)
    if isinstance(value, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(value, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(value, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(value, ast.BoolOp):
        for v in value.values:
            got = _infer_factory(v)
            if got is not None:
                return got
    if isinstance(value, ast.IfExp):
        return _infer_factory(value.body) or _infer_factory(value.orelse)
    return None


def _unwrap_iterable(node: ast.AST) -> ast.AST:
    """Peel ``list(X)`` / ``X.items()`` / ``X.values()`` / ``X.keys()``
    down to the X actually iterated."""

    while True:
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if isinstance(node.func, ast.Attribute) and \
                    name in ("items", "keys", "values"):
                node = node.func.value
                continue
            if isinstance(node.func, ast.Name) and \
                    name in SNAPSHOT_CALLS and node.args:
                node = node.args[0]
                continue
        return node


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    return any(n in ("Exception", "BaseException") for n in names)


class _MethodVisitor(ast.NodeVisitor):
    """One pass over one method body: attribute accesses with lockedness,
    lock-acquisition edges, in-class call sites, blocking calls."""

    def __init__(self, method: str, lock_attrs: Set[str],
                 attr_types: Dict[str, str]):
        self.method = method
        self.lock_attrs = lock_attrs
        self.attr_types = attr_types
        self.held: List[str] = []       # lock attrs currently held
        self.accesses: List[Access] = []
        # (attr, Access) pairs — the grouped-by-attribute view C001/C002
        # consume
        self.attr_access_pairs: List[Tuple[str, Access]] = []
        self.acquires: Set[str] = set()
        self.lock_edges: Set[Tuple[str, str]] = set()
        # (held_lock, callee) for one-hop transitive lock edges
        self.call_edges_under_lock: Set[Tuple[str, str]] = set()
        # callee -> [site locked?] — locked-context propagation input
        self.callsites: List[Tuple[str, bool]] = []
        self.blocking: List[BlockSite] = []
        self._iter_exprs: Set[int] = set()   # id()s consumed as iteration

    # -- helpers -------------------------------------------------------- #

    def _locked(self) -> bool:
        return bool(self.held)

    def _record(self, attr: str, kind: str, line: int) -> None:
        acc = Access(self.method, kind, line, self._locked())
        self.accesses.append(acc)
        self.attr_access_pairs.append((attr, acc))

    def _record_iterable(self, expr: ast.AST) -> None:
        base = _unwrap_iterable(expr)
        attr = _self_attr(base)
        if attr is not None:
            self._iter_exprs.add(id(base))
            self._record(attr, "iterate", expr.lineno)

    # -- structural visitors -------------------------------------------- #

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in self.lock_attrs:
                acquired.append(attr)
        for lock in acquired:
            self.acquires.add(lock)
            for held in self.held:
                if held != lock:
                    self.lock_edges.add((held, lock))
            self.held.append(lock)
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    def visit_For(self, node: ast.For) -> None:
        self._record_iterable(node.iter)
        self.generic_visit(node)

    def visit_comprehension_gens(self, generators) -> None:
        for gen in generators:
            self._record_iterable(gen.iter)

    def visit_ListComp(self, node):
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_SetComp(self, node):
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_DictComp(self, node):
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_GeneratorExp(self, node):
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def _record_target(self, target: ast.AST, kind_plain: str) -> None:
        attr = _self_attr(target)
        if attr is not None:
            self._record(attr, kind_plain, target.lineno)
            return
        if isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
            if attr is not None:
                self._record(attr, "subwrite", target.lineno)
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, kind_plain)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._record_target(target, "write")
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is not None:
            self._record(attr, "aug", node.lineno)
        elif isinstance(node.target, ast.Subscript):
            sub = _self_attr(node.target.value)
            if sub is not None:
                self._record(sub, "subwrite", node.lineno)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                attr = _self_attr(target.value)
                if attr is not None:
                    self._record(attr, "delete", node.lineno)
            else:
                attr = _self_attr(target)
                if attr is not None:
                    self._record(attr, "delete", node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # snapshot-style bulk reads: list(self.x), sorted(self.x.items())
        if isinstance(func, ast.Name) and func.id in SNAPSHOT_CALLS \
                and node.args:
            base = _unwrap_iterable(node)
            attr = _self_attr(base)
            if attr is not None and id(base) not in self._iter_exprs:
                self._iter_exprs.add(id(base))
                self._record(attr, "iterate", node.lineno)
        if isinstance(func, ast.Attribute):
            recv_attr = _self_attr(func.value)
            # self.x.append(...) — mutation through the attribute
            if recv_attr is not None and func.attr in MUTATOR_METHODS and \
                    self.attr_types.get(recv_attr) not in SAFE_FACTORIES:
                self._record(recv_attr, "mutcall", node.lineno)
            # self.m(...) — in-class call site
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                self.callsites.append((func.attr, self._locked()))
                if self.held:
                    for held in self.held:
                        self.call_edges_under_lock.add((held, func.attr))
            self._check_blocking(node, func)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._record(attr, "read", node.lineno)
        self.generic_visit(node)

    # -- blocking-call scan (C004) -------------------------------------- #

    def _check_blocking(self, node: ast.Call, func: ast.Attribute) -> None:
        if not self.held:
            return
        lock = self.held[-1]
        kwargs = {k.arg for k in node.keywords}
        recv_attr = _self_attr(func.value)
        recv_is_lock = recv_attr in self.lock_attrs
        if func.attr in BLOCKING_ATTR_CALLS:
            self.blocking.append(BlockSite(
                self.method, node.lineno,
                f"blocking `{func.attr}()` call", True, lock))
        elif func.attr in ("get", "put") and recv_attr is not None and \
                self.attr_types.get(recv_attr, "").endswith("Queue") and \
                "timeout" not in kwargs:
            self.blocking.append(BlockSite(
                self.method, node.lineno,
                f"untimed queue `{func.attr}()` on self.{recv_attr}",
                True, lock))
        elif func.attr == "join" and "timeout" not in kwargs and \
                not node.args and recv_attr is not None and \
                self.attr_types.get(recv_attr) == "Thread":
            self.blocking.append(BlockSite(
                self.method, node.lineno,
                f"untimed `join()` on self.{recv_attr}", True, lock))
        elif func.attr == "sleep" and isinstance(func.value, ast.Name) \
                and func.value.id == "time":
            self.blocking.append(BlockSite(
                self.method, node.lineno, "`time.sleep()` under a lock",
                True, lock))
        elif func.attr in BLOCKING_SUBPROCESS_FUNCS and \
                isinstance(func.value, ast.Name) and \
                func.value.id == "subprocess":
            self.blocking.append(BlockSite(
                self.method, node.lineno,
                f"`subprocess.{func.attr}()` under a lock", True, lock))
        elif func.attr == "wait" and not recv_is_lock and \
                "timeout" not in kwargs and not node.args and \
                not (recv_attr is not None and
                     self.attr_types.get(recv_attr) in SAFE_FACTORIES):
            # untimed wait on a non-lock receiver: subprocess.Popen.wait,
            # futures — Condition.wait on a HELD lock releases it and is
            # excluded via recv_is_lock; Event waits are SAFE_FACTORIES
            self.blocking.append(BlockSite(
                self.method, node.lineno, "untimed `wait()` call", True,
                lock))


class ClassModel:
    """Everything the checks need about one class."""

    def __init__(self, node: ast.ClassDef, path: str):
        self.node = node
        self.path = path
        self.name = node.name
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.lock_attrs: Set[str] = set()
        self.attr_types: Dict[str, str] = {}
        self.thread_targets: Set[str] = set()
        self._collect_attr_types()
        self._collect_thread_targets()
        self.visitors: Dict[str, _MethodVisitor] = {}
        for name, fn in self.methods.items():
            v = _MethodVisitor(name, self.lock_attrs, self.attr_types)
            for stmt in fn.body:
                v.visit(stmt)
            self.visitors[name] = v
        self.calls: Dict[str, Set[str]] = {
            m: self._referenced_methods(fn) for m, fn in self.methods.items()}
        self.init_context = self._closure_called_only_from({"__init__"})
        self.thread_context = self._reachable_from(self.thread_targets)
        self.locked_context = self._locked_context()
        self.spawn_methods = self._spawn_methods()

    # -- model construction --------------------------------------------- #

    def _collect_attr_types(self) -> None:
        init = self.methods.get("__init__")
        scan_fns = [fn for fn in self.methods.values()]
        for fn in ([init] if init is not None else scan_fns):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign) and \
                        node.value is not None:
                    targets = [node.target]
                else:
                    continue
                for target in targets:
                    attr = _self_attr(target)
                    if attr is None:
                        continue
                    factory = _infer_factory(node.value)
                    if factory in LOCK_FACTORIES or \
                            factory in WITNESS_FACTORIES:
                        self.lock_attrs.add(attr)
                        self.attr_types[attr] = "Lock"
                    elif factory is not None and \
                            attr not in self.attr_types:
                        self.attr_types[attr] = factory

    def _collect_thread_targets(self) -> None:
        for node in ast.walk(self.node):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        attr = _self_attr(kw.value)
                        if attr is not None:
                            self.thread_targets.add(attr)
            elif name in ("submit", "map") and \
                    isinstance(node.func, ast.Attribute) and node.args:
                attr = _self_attr(node.args[0])
                if attr is not None:
                    self.thread_targets.add(attr)

    def _spawn_methods(self) -> Set[str]:
        """Methods that construct this class's threads themselves
        (``start()``-style).  A plain attribute rebind there, before the
        ``Thread.start()`` happens-before edge, is safe publication —
        not a racing mutation."""

        out = set()
        for name, fn in self.methods.items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        _call_name(node) == "Thread":
                    out.add(name)
                    break
        return out

    def _referenced_methods(self, fn: ast.FunctionDef) -> Set[str]:
        refs = set()
        for node in ast.walk(fn):
            attr = _self_attr(node)
            if attr is not None and attr in self.methods:
                refs.add(attr)
        return refs

    def _reachable_from(self, roots: Set[str]) -> Set[str]:
        seen = set()
        frontier = [r for r in roots if r in self.methods]
        while frontier:
            m = frontier.pop()
            if m in seen:
                continue
            seen.add(m)
            frontier.extend(self.calls.get(m, ()))
        return seen

    def _closure_called_only_from(self, roots: Set[str]) -> Set[str]:
        """Private methods every in-class call site of which lies in
        ``roots`` (transitively) — the init-context closure."""

        context = set(roots)
        changed = True
        callers: Dict[str, Set[str]] = {}
        for caller, v in self.visitors.items():
            for callee, _ in v.callsites:
                callers.setdefault(callee, set()).add(caller)
        while changed:
            changed = False
            for m in self.methods:
                if m in context or not m.startswith("_") or \
                        m.startswith("__"):
                    continue
                sites = callers.get(m)
                if sites and sites <= context:
                    context.add(m)
                    changed = True
        return context

    def _locked_context(self) -> Set[str]:
        """Private methods whose every in-class call site holds a lock
        (directly, or via another locked-context method)."""

        locked: Set[str] = set()
        sites: Dict[str, List[Tuple[str, bool]]] = {}
        for caller, v in self.visitors.items():
            for callee, is_locked in v.callsites:
                sites.setdefault(callee, []).append((caller, is_locked))
        changed = True
        while changed:
            changed = False
            for m in self.methods:
                if m in locked or not m.startswith("_") or \
                        m.startswith("__") or m not in sites:
                    continue
                if all(is_locked or caller in locked
                       for caller, is_locked in sites[m]):
                    locked.add(m)
                    changed = True
        return locked

def _grouped_accesses(model: ClassModel) -> Dict[str, List[Access]]:
    """``{attr: [Access, ...]}`` with locked-context re-tagging."""

    grouped: Dict[str, List[Access]] = {}
    for mname in model.methods:
        v = model.visitors[mname]
        in_locked_ctx = mname in model.locked_context
        for attr, acc in v.attr_access_pairs:
            if in_locked_ctx and not acc.locked:
                acc = Access(acc.method, acc.kind, acc.line, True)
            grouped.setdefault(attr, []).append(acc)
    return grouped


# --------------------------------------------------------------------- #
# checks
# --------------------------------------------------------------------- #


def _check_shared_writes(model: ClassModel) -> List[Finding]:
    """DKS-C001 + DKS-C002 over one class."""

    findings: List[Finding] = []
    if not model.lock_attrs:
        return findings
    grouped = _grouped_accesses(model)
    for attr, accesses in sorted(grouped.items()):
        if attr in model.lock_attrs or \
                model.attr_types.get(attr) in SAFE_FACTORIES:
            continue
        live = [a for a in accesses if a.method not in model.init_context]
        mutations = [a for a in live if a.kind in MUTATION_KINDS]
        if not mutations:
            continue
        # C002: unlocked iteration over an in-place-mutated raising
        # container — applies to any lock-owning class (handler threads
        # mutate registries too)
        inplace = [a for a in mutations if a.kind in INPLACE_KINDS]
        if model.attr_types.get(attr) in RAISING_CONTAINERS and inplace:
            mutating_methods = {a.method for a in inplace}
            for a in live:
                if a.kind == "iterate" and not a.locked and \
                        (mutating_methods - {a.method} or
                         a.method in model.thread_context):
                    findings.append(Finding(
                        "DKS-C002", model.path, a.line,
                        f"{model.name}.{attr}",
                        f"iterates `self.{attr}` outside the lock while "
                        f"{_fmt_methods(mutating_methods)} mutates it",
                        "snapshot under the lock (`list(...)`/`.copy()` "
                        "inside the `with`) and iterate the snapshot"))
        # C001 needs real thread structure on the class
        if not model.thread_targets:
            continue
        thread_side = [a for a in live if a.method in model.thread_context]
        other_side = [a for a in live
                      if a.method not in model.thread_context]
        if not thread_side or not other_side:
            continue
        # the race needs an UNLOCKED mutation; all-mutations-locked with
        # unlocked reads is the repo's deliberate append-only/rebind
        # pattern (reads tolerate a one-element-stale view).  A plain
        # rebind in a thread-spawning method is safe publication.
        unlocked = [a for a in mutations if not a.locked
                    and not (a.kind == "write"
                             and a.method in model.spawn_methods)]
        if not unlocked:
            continue
        a = min(unlocked, key=lambda x: x.line)
        findings.append(Finding(
            "DKS-C001", model.path, a.line, f"{model.name}.{attr}",
            f"`self.{attr}` is written from the thread-target call graph "
            f"({_fmt_methods({x.method for x in thread_side})}) and "
            f"accessed elsewhere "
            f"({_fmt_methods({x.method for x in other_side})}) without a "
            f"common lock guard",
            f"guard every access with `with self."
            f"{sorted(model.lock_attrs)[0]}:` (or make the attribute "
            f"thread-confined)"))
    return findings


def _fmt_methods(methods: Set[str]) -> str:
    names = sorted(methods)
    shown = ", ".join(names[:3])
    if len(names) > 3:
        shown += ", …"
    return shown


def _check_lock_order(model: ClassModel) -> List[Finding]:
    """DKS-C003: cycle in the class's lock acquisition graph."""

    edges: Set[Tuple[str, str]] = set()
    acquires_trans: Dict[str, Set[str]] = {}

    def trans(m: str, seen: Set[str]) -> Set[str]:
        if m in acquires_trans:
            return acquires_trans[m]
        if m in seen or m not in model.methods:
            return set()
        seen.add(m)
        got = set(model.visitors[m].acquires)
        for callee in model.calls.get(m, ()):
            got |= trans(callee, seen)
        acquires_trans[m] = got
        return got

    for mname, v in model.visitors.items():
        edges |= v.lock_edges
        for held, callee in v.call_edges_under_lock:
            for acquired in trans(callee, set()):
                if acquired != held:
                    edges.add((held, acquired))
    cycle = find_cycle({a: {b for x, b in edges if x == a}
                        for a, _ in edges})
    if cycle is None:
        return []
    line = model.node.lineno
    return [Finding(
        "DKS-C003", model.path, line, model.name,
        f"lock acquisition graph has a cycle: {' -> '.join(cycle)} "
        f"(deadlock hazard)",
        "impose one global acquisition order and release before "
        "acquiring the other lock")]


def find_cycle(graph: Dict[str, Set[str]]) -> Optional[List[str]]:
    """First cycle in a ``{node: {successors}}`` graph as a node path
    (``[a, b, a]``), or ``None``.  Shared with the runtime lockwitness."""

    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GREY
        stack.append(n)
        for succ in sorted(graph.get(n, ())):
            if color.get(succ, WHITE) == GREY:
                return stack[stack.index(succ):] + [succ]
            if color.get(succ, WHITE) == WHITE:
                got = dfs(succ)
                if got is not None:
                    return got
        stack.pop()
        color[n] = BLACK
        return None

    for node in sorted(graph):
        if color[node] == WHITE:
            got = dfs(node)
            if got is not None:
                return got
    return None


def _check_blocking(model: ClassModel) -> List[Finding]:
    """DKS-C004 over one class."""

    findings = []
    for mname, v in model.visitors.items():
        for site in v.blocking:
            findings.append(Finding(
                "DKS-C004", model.path, site.line,
                f"{model.name}.{mname}",
                f"{site.desc} while holding `self.{site.lock_name}` — "
                f"every thread contending on that lock stalls behind "
                f"the I/O",
                "move the blocking call outside the `with`, or bound it "
                "with a timeout"))
    return findings


def _check_thread_loops(tree: ast.Module, path: str) -> List[Finding]:
    """DKS-C005 over a module: every ``Thread(target=...)`` whose target
    resolves to a function in this module must guard its long-lived
    loop body."""

    findings: List[Finding] = []
    # thread-target names (`self.m` attrs and bare function names);
    # resolution is by name anywhere in the module — deliberately
    # scope-blind, matching how the repo wires its worker loops
    targets: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node) == "Thread":
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                attr = _self_attr(kw.value)
                if attr is not None:
                    targets.add(attr)
                elif isinstance(kw.value, ast.Name):
                    targets.add(kw.value.id)
    if not targets:
        return findings
    fns: Dict[str, List[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns.setdefault(node.name, []).append(node)
    checked: Set[int] = set()
    for name in sorted(targets):
        for fn in fns.get(name, []):
            if id(fn) in checked:
                continue
            checked.add(id(fn))
            findings.extend(_unguarded_loops(fn, path))
    return findings


def _unguarded_loops(fn: ast.FunctionDef, path: str) -> List[Finding]:
    guarded_whiles: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Try) and \
                any(_is_broad_handler(h) for h in node.handlers):
            for inner in ast.walk(node):
                if isinstance(inner, ast.While):
                    guarded_whiles.add(id(inner))
    findings = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.While):
            continue
        if id(node) in guarded_whiles:
            continue
        # a direct-child broad try inside the loop body guards the body
        if any(isinstance(child, ast.Try) and
               any(_is_broad_handler(h) for h in child.handlers)
               for child in node.body):
            continue
        # loops without calls can't raise meaningfully
        if not any(isinstance(n, ast.Call) for n in ast.walk(node)):
            continue
        findings.append(Finding(
            "DKS-C005", path, node.lineno, fn.name,
            f"thread target `{fn.name}` has a long-lived loop whose body "
            f"is not exception-guarded — the first unexpected raise "
            f"silently kills the worker thread",
            "wrap the loop body in try/except Exception with a log (or "
            "wrap the whole loop and treat exit as fatal on purpose)"))
    return findings


# --------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------- #


def check_module(tree: ast.Module, path: str) -> List[Finding]:
    """All concurrency findings for one parsed module."""

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            model = ClassModel(node, path)
            findings.extend(_check_shared_writes(model))
            findings.extend(_check_lock_order(model))
            findings.extend(_check_blocking(model))
    findings.extend(_check_thread_loops(tree, path))
    return findings
