"""Pass 5 — the concurrency certifier: lock-discipline proofs for the
host-side thread fabric.

The port of ``lighthouse_tpu/analysis/concurrency.py`` over the port's own
tree (``lighthouse_tpu_torch``): the firehose prep/device pipeline, the
beacon processor's worker pool, the request threads of the node's servers,
the local network, the serving mesh, the resilience watchdogs. Every module
importing ``threading`` is parsed and proved against four rules, a
package-wide lock-order graph is built and checked for deadlock cycles,
and a runtime lockdep wrapper cross-validates the static graph against the
acquisition orders actually observed.

Three coordinated pieces:

1. **Static lock-discipline certifier.** Per class, the guard relation
   (attribute -> lock) is inferred from accesses dominated by
   ``with self._lock:`` blocks; thread entrypoints (``Thread`` targets,
   serve-loop closures, the public API surface) are identified; and a
   shared-attribute mutation reachable from >= 2 entrypoint threads
   without the inferred guard is an ``unguarded-write`` finding. Module
   globals get the same treatment against module-level locks
   (``unguarded-global``). Context-sensitive: a private helper only ever
   called under the lock ("caller holds the lock" contracts) is proven
   guarded through the call-site held-set fixpoint, not flagged.

2. **Lock-order deadlock graph.** Nested ``with``-lock statements and
   intra-package call edges (``self.method()``, typed ``self.attr.m()``
   receivers, imported module functions, metrics-family globals) build
   the acquires-while-holding graph over lock *classes*
   (``module.Class.attr`` / ``module.GLOBAL`` identities, the standard
   lockdep keying). Any cycle is a ``lock-order-cycle`` finding, and a
   blocking call while holding a lock — a device barrier
   (``synchronize``), unbounded ``Thread.join()``, socket send/recv,
   untimed ``Condition.wait()`` / ``queue.get()`` — is a
   ``blocking-under-lock`` finding: the pattern behind watchdog
   false-trips and wedged shutdowns.

3. **Runtime lockdep cross-validation**, turned on by a call: ``install()``
   swaps ``threading.Lock/RLock/Condition`` for instrumented factories
   that record the creation site (matched back to the static
   ``module.Class.attr`` identity through the site map), the actual
   acquisition-order edges per thread, and hold times; ``uninstall()``
   restores them and ``lockdep_enabled()`` says whether they are
   installed (no environment variable). Observed edges are merged into
   the static graph (``merge_observed``), the union must stay acyclic, and
   static edges never observed are reported as the coverage gap. The CLI
   merges an observed graph written to
   ``lighthouse_tpu_torch/_build/analysis/LOCKDEP_OBSERVED.json`` (or the
   file ``--observed`` names) into ``CONCURRENCY_CERT.json``.

Like the hygiene linter, intentional sites carry a
``# lint: allow(<rule>)`` pragma (flagged line or the line above) with a
justification, and whole findings can live in the checked-in
``analysis/concurrency_baseline.json`` keyed by (path, rule, source
line), which is empty. The lifecycle rule (``unjoined-thread``) enforces
the shutdown discipline: a class that starts a thread must bound-join it
somewhere (stop-event + ``join`` with a timeout), so a wedged worker can
never hang shutdown silently.
"""

from __future__ import annotations

import ast
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

from .hygiene import _PRAGMA_RE, Finding, _dotted

__all__ = [
    "RULES",
    "certify_concurrency",
    "analyze_tree",
    "load_baseline",
    "write_cert",
    "install",
    "uninstall",
    "installed",
    "lockdep_enabled",
    "observed_report",
    "reset_observed",
    "merge_observed",
    "OBSERVED_DEFAULT_PATH",
]

RULES = {
    "unguarded-write": "shared attribute mutated without its inferred guard lock",
    "unguarded-global": "module global mutated without its inferred guard lock",
    "lock-order-cycle": "cycle in the acquires-while-holding lock graph",
    "blocking-under-lock": "blocking call while holding a lock",
    "unjoined-thread": "started thread with no bounded join on shutdown",
}

_LOCK_CTORS = {"Lock", "RLock"}
_COND_CTOR = "Condition"
# object-mutating method names (a call on a shared attribute that rewrites it)
_MUTATORS = {
    "append", "extend", "add", "update", "pop", "popleft", "appendleft",
    "insert", "remove", "discard", "clear", "setdefault", "popitem",
    "move_to_end",
}
# blocking-call table: attribute-call names that park the calling thread
# indefinitely. ``join``/``wait``/``get`` only count when untimed (no args /
# no timeout) — a bounded join/wait is exactly the discipline we enforce.
_BLOCKING_ALWAYS = {
    "synchronize",  # device barrier (torch.cuda / stream / event)
    "sendall", "sendto", "recv", "recvfrom", "accept", "connect",  # sockets
    "serve_forever",
}
_BLOCKING_UNTIMED = {"join", "wait", "get"}


# =============================================================================
# package model
# =============================================================================


@dataclass
class _Func:
    key: str                      # "mod.Class.meth" | "mod.func"
    node: ast.AST                 # FunctionDef / AsyncFunctionDef
    module: "_Module"
    cls: "_Class | None" = None
    # local facts (filled by _FuncScan)
    acquires: list = field(default_factory=list)     # (lock_id, lineno)
    edges: set = field(default_factory=set)          # (held, acq, lineno)
    blocking: list = field(default_factory=list)     # (desc, lineno, held_ids)
    calls: list = field(default_factory=list)        # (callee_key, lineno, held, on_self)
    worker_calls: list = field(default_factory=list) # closure calls (own thread)
    accesses: list = field(default_factory=list)     # _Access (methods only)
    global_writes: list = field(default_factory=list)   # (name, lineno, held)
    thread_starts: list = field(default_factory=list)   # (lineno, target_desc)
    has_bounded_join: bool = False
    # fixpoint summaries
    trans_acquires: set = field(default_factory=set)
    trans_blocking: tuple | None = None              # (desc, lineno) or None


@dataclass
class _Access:
    attr: str
    write: bool
    held: frozenset
    lineno: int
    method: str                   # method name within the class
    in_init: bool


@dataclass
class _Class:
    name: str
    module: "_Module"
    bases: list = field(default_factory=list)        # raw dotted base names
    locks: dict = field(default_factory=dict)        # attr -> (lock_id, lineno, kind)
    lock_aliases: dict = field(default_factory=dict) # attr -> attr (Condition(self._lock))
    attr_types: dict = field(default_factory=dict)   # attr -> class key
    methods: dict = field(default_factory=dict)      # name -> _Func
    thread_targets: set = field(default_factory=set) # method/closure root names

    def key(self) -> str:
        return f"{self.module.mod}.{self.name}"


@dataclass
class _Module:
    path: str                     # absolute
    rel: str                      # repo-relative (finding path)
    mod: str                      # dotted, package-relative ("firehose.engine")
    tree: ast.Module | None
    lines: list
    uses_threading: bool = False
    imports: dict = field(default_factory=dict)      # local name -> dotted target
    classes: dict = field(default_factory=dict)
    functions: dict = field(default_factory=dict)    # module-level funcs
    global_locks: dict = field(default_factory=dict) # name -> (lock_id, lineno, kind)
    global_types: dict = field(default_factory=dict) # name -> class key


class _Index:
    """The package-wide symbol index: modules, classes, functions, locks."""

    def __init__(self):
        self.modules: dict[str, _Module] = {}
        self.classes: dict[str, _Class] = {}
        self.funcs: dict[str, _Func] = {}
        self.lock_sites: dict[tuple, str] = {}       # (rel, lineno) -> lock_id

    def resolve_class(self, dotted: str) -> _Class | None:
        """Resolve a possibly re-exported dotted class name to a _Class."""
        for _ in range(4):
            cls = self.classes.get(dotted)
            if cls is not None:
                return cls
            # follow one re-export hop: "a.b.Name" where a.b is a module
            # whose imports bind Name
            mod, _, name = dotted.rpartition(".")
            m = self.modules.get(mod)
            if m is None or name not in m.imports:
                return None
            dotted = m.imports[name]
        return None

    def resolve_func(self, dotted: str) -> _Func | None:
        for _ in range(4):
            fn = self.funcs.get(dotted)
            if fn is not None:
                return fn
            mod, _, name = dotted.rpartition(".")
            m = self.modules.get(mod)
            if m is None or name not in m.imports:
                return None
            dotted = m.imports[name]
        return None

    def mro_lookup(self, cls: _Class, what: str, name: str, depth: int = 0):
        """Walk single-inheritance bases (package classes only)."""
        table = getattr(cls, what)
        if name in table:
            return table[name]
        if depth >= 4:
            return None
        for base in cls.bases:
            b = self.resolve_class(base)
            if b is not None:
                hit = self.mro_lookup(b, what, name, depth + 1)
                if hit is not None:
                    return hit
        return None

    def all_locks(self, cls: _Class) -> dict:
        """attr -> (lock_id, lineno, kind), inherited attrs included (keyed
        by the DEFINING class — the lockdep class identity)."""
        out: dict = {}
        stack, seen = [cls], set()
        while stack:
            c = stack.pop()
            if c.key() in seen:
                continue
            seen.add(c.key())
            for attr, rec in c.locks.items():
                out.setdefault(attr, rec)
            for attr, tgt in c.lock_aliases.items():
                out.setdefault(attr, out.get(tgt) or c.locks.get(tgt))
            for base in c.bases:
                b = self.resolve_class(base)
                if b is not None:
                    stack.append(b)
        return {a: r for a, r in out.items() if r is not None}


# the package this pass certifies (lock ids and lockdep sites are relative
# to it)
_PKG = "lighthouse_tpu_torch"


def _module_name(rel: str) -> str:
    """'lighthouse_tpu_torch/firehose/engine.py' -> 'firehose.engine'."""
    parts = rel.replace(os.sep, "/").split("/")
    if parts and parts[0] == _PKG:
        parts = parts[1:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "<root>"


def _resolve_imports(m: _Module) -> None:
    """Map local names to package-relative dotted targets."""
    pkg_parts = m.mod.split(".") if m.mod != "<root>" else []
    if m.path.endswith("__init__.py"):
        base = pkg_parts               # relative to the package itself
    else:
        base = pkg_parts[:-1]
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                if alias.name == "threading":
                    m.uses_threading = True
                m.imports[name] = alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                anchor = base[: len(base) - (node.level - 1)] if node.level > 1 else base
                prefix = ".".join(anchor + ([node.module] if node.module else []))
            else:
                prefix = node.module or ""
                if prefix == "threading":
                    m.uses_threading = True
            for alias in node.names:
                name = alias.asname or alias.name
                m.imports[name] = f"{prefix}.{alias.name}" if prefix else alias.name


def _lock_ctor_kind(call: ast.Call) -> str | None:
    d = _dotted(call.func)
    if d is None:
        return None
    tail = d.rsplit(".", 1)[-1]
    head = d.split(".")[0]
    if head not in ("threading",) and d != tail:
        return None
    if tail in _LOCK_CTORS:
        return tail.lower()
    if tail == _COND_CTOR:
        return "condition"
    return None


def _scan_module(m: _Module, index: _Index) -> None:
    """First pass: classes, lock attrs, attr/global types, module funcs."""
    _resolve_imports(m)
    for node in m.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            key = f"{m.mod}.{node.name}"
            fn = _Func(key, node, m)
            m.functions[node.name] = fn
            index.funcs[key] = fn
        elif isinstance(node, ast.ClassDef):
            cls = _Class(node.name, m)
            cls.bases = [b for b in (_dotted(x) for x in node.bases) if b]
            cls._bases_raw = list(cls.bases)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    key = f"{m.mod}.{cls.name}.{item.name}"
                    fn = _Func(key, item, m, cls)
                    cls.methods[item.name] = fn
                    index.funcs[key] = fn
            m.classes[cls.name] = cls
            index.classes[cls.key()] = cls
        elif (
            isinstance(node, (ast.Assign, ast.AnnAssign))
            and isinstance(getattr(node, "value", None), ast.Call)
        ):
            kind = _lock_ctor_kind(node.value)
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                if not isinstance(tgt, ast.Name):
                    continue
                if kind:
                    lock_id = f"{m.mod}.{tgt.id}"
                    m.global_locks[tgt.id] = (lock_id, node.lineno, kind)
                    index.lock_sites[(m.rel, node.lineno)] = lock_id
                else:
                    t = _callee_class_key(node.value, m, index)
                    if t:
                        m.global_types[tgt.id] = t
    # second sweep per class: __init__-declared locks / aliases / attr types
    for cls in m.classes.values():
        for meth in cls.methods.values():
            for st in ast.walk(meth.node):
                if not (
                    isinstance(st, (ast.Assign, ast.AnnAssign))
                    and isinstance(getattr(st, "value", None), ast.Call)
                ):
                    continue
                st_targets = (
                    st.targets if isinstance(st, ast.Assign) else [st.target]
                )
                for tgt in st_targets:
                    if not (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        continue
                    kind = _lock_ctor_kind(st.value)
                    if kind == "condition" and st.value.args:
                        # Condition(self._lock) ALIASES the existing lock
                        inner = st.value.args[0]
                        if (
                            isinstance(inner, ast.Attribute)
                            and isinstance(inner.value, ast.Name)
                            and inner.value.id == "self"
                        ):
                            cls.lock_aliases[tgt.attr] = inner.attr
                            continue
                    if kind:
                        lock_id = f"{cls.key()}.{tgt.attr}"
                        cls.locks[tgt.attr] = (lock_id, st.lineno, kind)
                        index.lock_sites[(m.rel, st.lineno)] = lock_id
                    else:
                        t = _callee_class_key(st.value, m, index)
                        if t:
                            cls.attr_types.setdefault(tgt.attr, t)


# metrics-family factory returns: module-global ``X = REGISTRY.counter(...)``
# binds an instance of the metrics class — the one return-type special case
# the lock graph needs (those globals are inc()'d from under other locks).
_FACTORY_RETURNS = {"counter": "Counter", "gauge": "Gauge", "histogram": "Histogram"}


def _callee_class_key(call: ast.Call, m: _Module, index: _Index) -> str | None:
    d = _dotted(call.func)
    if d is None:
        return None
    tail = d.rsplit(".", 1)[-1]
    if tail in _FACTORY_RETURNS and "." in d:
        key = f"utils.metrics.{_FACTORY_RETURNS[tail]}"
        if key in index.classes or not index.classes:
            return key
    head = d.split(".")[0]
    target = m.imports.get(head)
    if target is None:
        target = d if head in m.classes or head in m.functions else None
        if target is not None:
            target = f"{m.mod}.{d}"
    elif "." in d:
        target = f"{target}.{d.split('.', 1)[1]}"
    return target


# =============================================================================
# per-function fact extraction
# =============================================================================


class _FuncScan:
    """Walk one function body tracking the held-lock stack; record
    acquisitions, nested-acquire edges, resolved calls, blocking calls,
    self-attribute accesses and module-global accesses."""

    def __init__(self, fn: _Func, index: _Index, method_name: str = "",
                 in_init: bool = False):
        self.fn = fn
        self.index = index
        self.m = fn.module
        self.cls = fn.cls
        self.locks = index.all_locks(fn.cls) if fn.cls else {}
        self.method_name = method_name
        self.in_init = in_init
        self.self_method_refs: set = set()        # non-call self.<method> loads

    # -- lock-expression recognition ---------------------------------------

    def _lock_id_of(self, expr) -> tuple | None:
        """(lock_id, kind) when ``expr`` denotes a known lock."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            rec = self.locks.get(expr.attr)
            if rec:
                return rec[0], rec[2]
        elif isinstance(expr, ast.Name):
            rec = self.m.global_locks.get(expr.id)
            if rec:
                return rec[0], rec[2]
        return None

    # -- call resolution ----------------------------------------------------

    def _resolve_call(self, call: ast.Call) -> tuple | None:
        """(callee_key, on_self) for a package call we can name."""
        f = call.func
        if isinstance(f, ast.Attribute):
            recv = f.value
            if isinstance(recv, ast.Name) and recv.id == "self" and self.cls:
                meth = self.index.mro_lookup(self.cls, "methods", f.attr)
                if meth is not None:
                    return meth.key, True
                return None
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and self.cls
            ):
                t = self.index.mro_lookup(self.cls, "attr_types", recv.attr)
                if t:
                    cls = self.index.resolve_class(t)
                    if cls:
                        meth = self.index.mro_lookup(cls, "methods", f.attr)
                        if meth is not None:
                            return meth.key, False
                return None
            if isinstance(recv, ast.Name):
                # module-global instance or imported module
                t = self.m.global_types.get(recv.id)
                if t is None and recv.id in self.m.imports:
                    target = self.m.imports[recv.id]
                    fn = self.index.resolve_func(f"{target}.{f.attr}")
                    if fn is not None:
                        return fn.key, False
                    # imported instance global (a metrics family counter):
                    # type comes from the defining module's global table
                    t = self._imported_instance_type(recv.id)
                if t:
                    cls = self.index.resolve_class(t)
                    if cls:
                        meth = self.index.mro_lookup(cls, "methods", f.attr)
                        if meth is not None:
                            return meth.key, False
            return None
        if isinstance(f, ast.Name):
            if f.id in self.m.functions:
                return self.m.functions[f.id].key, False
            if self.cls and f.id in self.m.classes:
                ctor = self.index.mro_lookup(self.m.classes[f.id], "methods", "__init__")
                if ctor is not None:
                    return ctor.key, False
            target = self.m.imports.get(f.id)
            if target:
                fn = self.index.resolve_func(target)
                if fn is not None:
                    return fn.key, False
                cls = self.index.resolve_class(target)
                if cls is not None:
                    ctor = self.index.mro_lookup(cls, "methods", "__init__")
                    if ctor is not None:
                        return ctor.key, False
        return None

    def _imported_instance_type(self, name: str) -> str | None:
        """``from ..utils.metrics import FIREHOSE_DROPPED`` -> Counter."""
        target = self.m.imports.get(name)
        if not target:
            return None
        mod, _, sym = target.rpartition(".")
        src = self.index.modules.get(mod)
        if src is not None:
            return src.global_types.get(sym)
        return None

    # -- blocking-call recognition ------------------------------------------

    def _blocking_desc(self, call: ast.Call) -> str | None:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        name = f.attr
        if name in _BLOCKING_ALWAYS:
            # ",".join(...)-style false positives cannot arise here; the
            # always-blocking names are device/socket verbs
            return f".{name}()"
        if name not in _BLOCKING_UNTIMED:
            return None
        if any(kw.arg == "timeout" for kw in call.keywords):
            return None
        if name == "join":
            # str.join / os.path.join always take an argument; Thread.join()
            # is unbounded exactly when called with none
            return ".join() [unbounded]" if not call.args and not call.keywords else None
        if name == "get":
            # dict.get(k) has args; Queue.get() / Queue.get(True) block
            if not call.args:
                return ".get() [untimed]"
            if (
                len(call.args) == 1
                and isinstance(call.args[0], ast.Constant)
                and call.args[0].value is True
            ):
                return ".get(True) [untimed]"
            return None
        if name == "wait":
            # Condition.wait() / Event.wait() with no timeout parks forever
            return ".wait() [untimed]" if not call.args else None
        return None

    # -- thread lifecycle ---------------------------------------------------

    def _note_thread(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        if d not in ("threading.Thread", "Thread"):
            return
        target = ""
        for kw in node.keywords:
            if kw.arg == "target":
                target = _dotted(kw.value) or "<expr>"
        self.fn.thread_starts.append((node.lineno, target))
        if self.cls is not None and target.startswith("self."):
            self.cls.thread_targets.add(target[len("self."):])

    # -- the walk -----------------------------------------------------------

    def run(self) -> None:
        body = self.fn.node.body
        self._walk(body, ())
        if self.fn.thread_starts and self.cls is not None:
            # a thread-starting method that holds bare references to own
            # methods is handing them to Thread(target=...) through a
            # variable (the firehose double-loop idiom); a local-closure
            # target makes the method itself the worker root
            self.cls.thread_targets |= self.self_method_refs
            if any(
                t and not t.startswith("self.")
                for _ln, t in self.fn.thread_starts
            ):
                self.cls.thread_targets.add(self.method_name)

    def _walk(self, stmts, held: tuple) -> None:
        for st in stmts:
            if isinstance(st, ast.With):
                acquired = []
                for item in st.items:
                    rec = self._lock_id_of(item.context_expr)
                    if rec is not None:
                        lock_id, kind = rec
                        self.fn.acquires.append((lock_id, st.lineno))
                        for h in held + tuple(acquired):
                            if h != lock_id:
                                self.fn.edges.add((h, lock_id, st.lineno))
                            elif kind == "lock":
                                # same non-reentrant lock nested on the same
                                # object: guaranteed self-deadlock
                                self.fn.edges.add((h, lock_id, st.lineno))
                        acquired.append(lock_id)
                    else:
                        self._scan_expr(item.context_expr, held)
                self._walk(st.body, held + tuple(acquired))
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # closures (Thread targets, local workers) run later on
                # their own thread: their acquisitions/blocking belong to a
                # SYNTHETIC function (own entry, empty held set) so the
                # fixpoint never attributes worker-thread operations to
                # inline callers of the enclosing method — only the
                # attribute accesses stay with the method, feeding the
                # guard analysis under its thread-root label
                sub_fn = _Func(
                    f"{self.fn.key}.<{st.name}>", st, self.fn.module,
                    self.fn.cls,
                )
                self.index.funcs[sub_fn.key] = sub_fn
                sub = _FuncScan(sub_fn, self.index, self.method_name,
                                self.in_init)
                sub._walk(st.body, ())
                self.fn.accesses.extend(sub_fn.accesses)
                self.fn.global_writes.extend(sub_fn.global_writes)
                self.fn.thread_starts.extend(sub_fn.thread_starts)
                self.fn.worker_calls.extend(
                    sub_fn.calls + sub_fn.worker_calls
                )
                if sub_fn.has_bounded_join:
                    self.fn.has_bounded_join = True
                self.self_method_refs |= sub.self_method_refs
                continue
            # attribute / global writes at statement level
            if isinstance(st, ast.Assign):
                for tgt in st.targets:
                    self._note_store(tgt, held, st.lineno)
                self._scan_expr(st.value, held)
                continue
            if isinstance(st, ast.AugAssign):
                self._note_store(st.target, held, st.lineno)
                self._scan_expr(st.value, held)
                continue
            if isinstance(st, ast.AnnAssign):
                if st.value is not None:   # bare annotations store nothing
                    self._note_store(st.target, held, st.lineno)
                    self._scan_expr(st.value, held)
                continue
            if isinstance(st, ast.Delete):
                for tgt in st.targets:
                    self._note_store(tgt, held, st.lineno)
                continue
            # recurse: statements with bodies keep the held set (except
            # handlers are ExceptHandler nodes, not stmts — walk their
            # bodies explicitly or the whole fault path goes unanalyzed)
            for fieldname, value in ast.iter_fields(st):
                if isinstance(value, list) and value and isinstance(value[0], ast.stmt):
                    self._walk(value, held)
                elif isinstance(value, list) and value and isinstance(
                    value[0], ast.ExceptHandler
                ):
                    for h in value:
                        self._walk(h.body, held)
                elif isinstance(value, ast.stmt):
                    self._walk([value], held)
                elif isinstance(value, ast.expr):
                    self._scan_expr(value, held)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.expr):
                            self._scan_expr(v, held)

    def _note_store(self, tgt, held: tuple, lineno: int) -> None:
        held_f = frozenset(held)
        if (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
            and self.cls is not None
        ):
            if tgt.attr not in self.locks:
                self.fn.accesses.append(_Access(
                    tgt.attr, True, held_f, lineno, self.method_name,
                    self.in_init,
                ))
        elif isinstance(tgt, ast.Subscript):
            base = tgt.value
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and self.cls is not None
            ):
                self.fn.accesses.append(_Access(
                    base.attr, True, held_f, lineno, self.method_name,
                    self.in_init,
                ))
            elif isinstance(base, ast.Name) and base.id in self._module_globals():
                self.fn.global_writes.append((base.id, lineno, held_f))
        elif isinstance(tgt, ast.Name) and self.fn.cls is None:
            # rebinding a module global needs a `global` decl to matter;
            # treat names declared global in this function as global stores
            if base_is_global(self.fn.node, tgt.id):
                self.fn.global_writes.append((tgt.id, lineno, held_f))
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._note_store(el, held, lineno)

    def _module_globals(self) -> set:
        return set(self.m.global_types) | {
            n for n in self.m.global_locks
        } | getattr(self.m, "_mutable_globals", set())

    def _scan_expr(self, expr, held: tuple) -> None:
        held_f = frozenset(held)
        callee_nodes: set = set()     # Attribute nodes in call position
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                if (
                    isinstance(node, ast.Attribute)
                    and id(node) not in callee_nodes
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and self.cls is not None
                    and node.attr not in self.locks
                ):
                    if node.attr in self.cls.methods:
                        self.self_method_refs.add(node.attr)
                    self.fn.accesses.append(_Access(
                        node.attr, False, held_f, node.lineno,
                        self.method_name, self.in_init,
                    ))
                continue
            callee_nodes.add(id(node.func))
            self._note_thread(node)
            f = node.func
            # mutator call on a shared attribute / global
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                recv = f.value
                if (
                    isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id == "self"
                    and self.cls is not None
                ):
                    self.fn.accesses.append(_Access(
                        recv.attr, True, held_f, node.lineno,
                        self.method_name, self.in_init,
                    ))
                elif isinstance(recv, ast.Name) and recv.id in self._module_globals():
                    self.fn.global_writes.append((recv.id, node.lineno, held_f))
            if isinstance(f, ast.Attribute) and f.attr == "join":
                # only the canonical bounded form counts — join(timeout=...)
                # — so str.join can never satisfy the lifecycle rule
                if any(kw.arg == "timeout" for kw in node.keywords):
                    self.fn.has_bounded_join = True
            desc = self._blocking_desc(node)
            if desc is not None:
                self.fn.blocking.append((desc, node.lineno, held_f))
            resolved = self._resolve_call(node)
            if resolved is not None:
                key, on_self = resolved
                self.fn.calls.append((key, node.lineno, held_f, on_self))


def base_is_global(fn_node, name: str) -> bool:
    for st in ast.walk(fn_node):
        if isinstance(st, ast.Global) and name in st.names:
            return True
    return False


# =============================================================================
# the tree analysis
# =============================================================================


def _collect_mutable_globals(m: _Module) -> None:
    """Names assigned a mutable container at module level (the fault ring,
    peer tables, caches): candidates for the unguarded-global rule."""
    mut: set = set()
    for node in m.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            v = getattr(node, "value", None)
            is_mut = isinstance(v, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(v, ast.Call)
                and (_dotted(v.func) or "").rsplit(".", 1)[-1]
                in ("dict", "list", "set", "deque", "OrderedDict", "defaultdict")
            )
            if is_mut:
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in targets:
                    if isinstance(tgt, ast.Name):
                        mut.add(tgt.id)
    m._mutable_globals = mut


_PARSED: dict = {}  # root -> (the tree's (path, mtime, size) signature, index)


def _tree_signature(root: str) -> tuple:
    sig = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                st = os.stat(os.path.join(dirpath, fn))
                sig.append((dirpath, fn, st.st_mtime_ns, st.st_size))
    return tuple(sig)


def _parse_tree(root: str) -> _Index:
    """The index of ``root``, parsed once per state of its sources (the
    lockdep site map and the certificate of one process share it)."""
    sig = _tree_signature(root)
    hit = _PARSED.get(root)
    if hit is not None and hit[0] == sig:
        return hit[1]
    index = _parse_tree_uncached(root)
    _PARSED[root] = (sig, index)
    return index


def _parse_tree_uncached(root: str) -> _Index:
    index = _Index()
    pkg_parent = os.path.dirname(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, pkg_parent)
            try:
                with open(full) as f:
                    src = f.read()
                tree = ast.parse(src)
            except (OSError, SyntaxError):
                continue
            m = _Module(full, rel, _module_name(rel), tree, src.splitlines())
            index.modules[m.mod] = m
    for m in index.modules.values():
        _collect_mutable_globals(m)
        _scan_module(m, index)
    # base names resolve against the defining module: same-module classes
    # first, then the import table (inheritance carries lock attrs)
    for m in index.modules.values():
        for cls in m.classes.values():
            cls.bases = [
                f"{m.mod}.{b}" if b in m.classes else m.imports.get(b, b)
                for b in cls._bases_raw
            ]
    # fact extraction over every function in the package (call summaries
    # must cross into modules that do not themselves import threading)
    for m in index.modules.values():
        for fn in m.functions.values():
            _FuncScan(fn, index).run()
        for cls in m.classes.values():
            for name, meth in cls.methods.items():
                _FuncScan(meth, index, name, in_init=(name == "__init__")).run()
    return index


def _fixpoint_summaries(index: _Index) -> tuple[set, list]:
    """Propagate acquisitions and blocking calls through the call graph.
    Returns (global lock-order edges, blocking findings raw)."""
    funcs = list(index.funcs.values())
    for fn in funcs:
        fn.trans_acquires = {a for a, _ in fn.acquires}
        fn.trans_blocking = fn.blocking[0][:2] if fn.blocking else None
    for _ in range(24):
        changed = False
        for fn in funcs:
            for key, _ln, _held, _on_self in fn.calls:
                callee = index.funcs.get(key)
                if callee is None:
                    continue
                before = len(fn.trans_acquires)
                fn.trans_acquires |= callee.trans_acquires
                if len(fn.trans_acquires) != before:
                    changed = True
                if fn.trans_blocking is None and callee.trans_blocking is not None:
                    fn.trans_blocking = (
                        f"{callee.trans_blocking[0]} via {key.rsplit('.', 1)[-1]}()",
                        None,
                    )
                    changed = True
        if not changed:
            break
    edges: dict[tuple, tuple] = {}   # (held, acq) -> (rel, lineno)
    blocking_raw: list = []          # (rel, lineno, desc, held_ids)
    for fn in funcs:
        for held, acq, ln in fn.edges:
            edges.setdefault((held, acq), (fn.module.rel, ln))
        for desc, ln, held in fn.blocking:
            if held:
                blocking_raw.append((fn.module.rel, ln, desc, held))
        for key, ln, held, on_self in fn.calls:
            if not held:
                continue
            callee = index.funcs.get(key)
            if callee is None:
                continue
            for acq in callee.trans_acquires:
                for h in held:
                    if h != acq:
                        edges.setdefault((h, acq), (fn.module.rel, ln))
                    elif not on_self:
                        # same lock CLASS on (possibly) another instance:
                        # not provably the same object — skip the self-edge
                        pass
            if callee.trans_blocking is not None:
                desc = callee.trans_blocking[0]
                blocking_raw.append(
                    (fn.module.rel, ln,
                     f"{desc} inside {key.rsplit('.', 1)[-1]}()", held)
                )
    return edges, blocking_raw


def _find_cycles(edges: dict) -> list[list[str]]:
    """Elementary cycles via DFS (the graph is small: tens of nodes)."""
    graph: dict[str, set] = defaultdict(set)
    for (a, b) in edges:
        graph[a].add(b)
    cycles: list[list[str]] = []
    seen_keys: set = set()

    def dfs(start: str, node: str, path: list, visited: set) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cyc = path[:]
                # rotation-invariant key so one cycle reports once
                i = cyc.index(min(cyc))
                key = tuple(cyc[i:] + cyc[:i])
                if key not in seen_keys:
                    seen_keys.add(key)
                    cycles.append(cyc + [start])
            elif nxt not in visited and nxt > start:
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)

    for n in sorted(graph):
        dfs(n, n, [n], {n})
    return cycles


# -- guard inference ----------------------------------------------------------


def _class_findings(index: _Index, findings: list) -> None:
    for m in index.modules.values():
        if not m.uses_threading:
            continue
        for cls in m.classes.values():
            locks = index.all_locks(cls)
            if not locks and not cls.thread_targets:
                continue
            lock_ids = {rec[0] for rec in locks.values()}
            accesses: list[_Access] = []
            for meth in cls.methods.values():
                accesses.extend(meth.accesses)
            # context-sensitive entry held-sets: intersection over call sites
            entry = _entry_held(index, cls)
            methods = set(cls.methods)

            def effective(acc: _Access) -> frozenset:
                e = entry.get(acc.method)
                if e is None:          # never called: unreachable, assume safe
                    return frozenset(lock_ids)
                return acc.held | e

            # guard inference: the lock most often held across accesses
            per_attr: dict[str, list[_Access]] = defaultdict(list)
            for acc in accesses:
                if acc.attr in methods or acc.attr in cls.attr_types:
                    continue           # method refs / owned sub-objects
                per_attr[acc.attr].append(acc)
            guards: dict[str, str] = {}
            for attr, accs in per_attr.items():
                votes: dict[str, int] = defaultdict(int)
                for acc in accs:
                    if acc.in_init:
                        continue
                    for lid in effective(acc) & lock_ids:
                        votes[lid] += 1
                if votes:
                    guards[attr] = max(sorted(votes), key=lambda k: votes[k])
            # thread-entry roots: each Thread-target method is its own root;
            # the public API surface is one shared root
            roots: dict[str, str] = {}
            for t in cls.thread_targets:
                roots[t] = f"thread:{t}"
            for name in cls.methods:
                if not name.startswith("_") and name not in roots:
                    roots[name] = "api"
            reach = _reachable_roots(index, cls, roots)
            for attr, accs in sorted(per_attr.items()):
                guard = guards.get(attr)
                writer_roots = set()
                toucher_roots = set()
                for acc in accs:
                    if acc.in_init:
                        continue
                    rts = reach.get(acc.method, set())
                    toucher_roots |= rts
                    if acc.write:
                        writer_roots |= rts
                for acc in accs:
                    if not acc.write or acc.in_init:
                        continue
                    eff = effective(acc)
                    if guard is not None:
                        if guard not in eff and len(toucher_roots) >= 2:
                            findings.append(_mk(
                                m, acc.lineno, "unguarded-write",
                                f"`self.{attr}` is guarded by `{guard.rsplit('.', 1)[-1]}`"
                                f" elsewhere but mutated without it in"
                                f" {cls.name}.{acc.method} (reachable from"
                                f" {_fmt_roots(toucher_roots)})",
                            ))
                    elif len(writer_roots) >= 2 and not (eff & lock_ids):
                        findings.append(_mk(
                            m, acc.lineno, "unguarded-write",
                            f"`self.{attr}` mutated lock-free in"
                            f" {cls.name}.{acc.method} with writers on"
                            f" {_fmt_roots(writer_roots)} and no inferred guard",
                        ))


def _fmt_roots(roots: set) -> str:
    return " + ".join(sorted(roots))


def _entry_held(index: _Index, cls: _Class) -> dict:
    """method -> intersection of held-lock sets across its call sites
    (roots enter with the empty set). None = never called."""
    entry: dict[str, frozenset | None] = {}
    for name in cls.methods:
        is_root = (
            not name.startswith("_")
            or name in cls.thread_targets
            or name.startswith("__")
        )
        entry[name] = frozenset() if is_root else None
    for _ in range(12):
        changed = False
        for name, meth in cls.methods.items():
            e = entry[name]
            if e is None:
                continue
            # worker-closure call sites enter the callee on their own
            # thread: the spawning method's entry context does NOT carry in
            sites = [
                (key, frozenset(held) | e, on_self)
                for key, _ln, held, on_self in meth.calls
            ] + [
                (key, frozenset(held), on_self)
                for key, _ln, held, on_self in meth.worker_calls
            ]
            for key, cand, on_self in sites:
                if not on_self:
                    continue
                callee = key.rsplit(".", 1)[-1]
                if callee not in entry:
                    continue
                cur = entry[callee]
                new = cand if cur is None else (cur & cand)
                if new != cur:
                    entry[callee] = new
                    changed = True
        if not changed:
            break
    return entry


def _reachable_roots(index: _Index, cls: _Class, roots: dict) -> dict:
    """method -> set of root labels that can reach it."""
    calls: dict[str, set] = defaultdict(set)
    for name, meth in cls.methods.items():
        for key, _ln, _held, on_self in meth.calls + meth.worker_calls:
            if on_self:
                calls[name].add(key.rsplit(".", 1)[-1])
    reach: dict[str, set] = defaultdict(set)
    for root_meth, label in roots.items():
        stack, seen = [root_meth], set()
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            reach[n].add(label)
            stack.extend(calls.get(n, ()))
    return reach


def _global_findings(index: _Index, findings: list) -> None:
    """unguarded-global: a module global written both under and outside a
    module-level lock (the fault-ring / registry pattern)."""
    for m in index.modules.values():
        if not m.uses_threading or not m.global_locks:
            continue
        lock_ids = {rec[0] for rec in m.global_locks.values()}
        writes: dict[str, list] = defaultdict(list)
        for fn in m.functions.values():
            for name, ln, held in fn.global_writes:
                writes[name].append((ln, held, fn))
        for cls in m.classes.values():
            for fn in cls.methods.values():
                for name, ln, held in fn.global_writes:
                    writes[name].append((ln, held, fn))
        for name, sites in sorted(writes.items()):
            guarded = [s for s in sites if frozenset(s[1]) & lock_ids]
            if not guarded:
                continue
            guard = sorted(frozenset(guarded[0][1]) & lock_ids)[0]
            for ln, held, fn in sites:
                if not (frozenset(held) & lock_ids):
                    findings.append(_mk(
                        m, ln, "unguarded-global",
                        f"module global `{name}` is guarded by"
                        f" `{guard.rsplit('.', 1)[-1]}` elsewhere but mutated"
                        f" without it in {fn.key.rsplit('.', 1)[-1]}",
                    ))


def _lifecycle_findings(index: _Index, findings: list) -> None:
    """unjoined-thread: a scope that starts a thread whose owning class (or
    function) never bound-joins any thread."""
    for m in index.modules.values():
        if not m.uses_threading:
            continue
        for cls in m.classes.values():
            starts = []
            joined = False
            for meth in cls.methods.values():
                starts.extend(meth.thread_starts)
                joined = joined or meth.has_bounded_join
            if starts and not joined:
                for ln, target in starts:
                    findings.append(_mk(
                        m, ln, "unjoined-thread",
                        f"{cls.name} starts a thread"
                        f"{f' (target={target})' if target else ''} but no"
                        " method bound-joins it on shutdown (stop-event +"
                        " join(timeout=...))",
                    ))
        for fn in m.functions.values():
            if fn.thread_starts and not fn.has_bounded_join:
                for ln, target in fn.thread_starts:
                    findings.append(_mk(
                        m, ln, "unjoined-thread",
                        f"{fn.key.rsplit('.', 1)[-1]}() starts a thread"
                        f"{f' (target={target})' if target else ''} without a"
                        " bounded join",
                    ))


def _mk(m: _Module, lineno: int, rule: str, message: str) -> Finding:
    ctx = m.lines[lineno - 1].strip() if 0 < lineno <= len(m.lines) else ""
    return Finding(m.rel, lineno, rule, message, ctx)


# =============================================================================
# public entry points
# =============================================================================


_BASELINE_PATH = os.path.join(
    os.path.dirname(__file__), "concurrency_baseline.json"
)
OBSERVED_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "analysis",
    "LOCKDEP_OBSERVED.json",
)


def git_head() -> str | None:
    """Best-effort HEAD of the repo this package lives in (stamps the
    lockdep artifact so a stale observed graph is never merged)."""
    try:
        import subprocess

        proc = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        )
        return proc.stdout.strip() or None if proc.returncode == 0 else None
    except Exception:  # noqa: BLE001 — no git, no stamp
        return None


def load_baseline(path: str | None = None) -> set:
    try:
        with open(path or _BASELINE_PATH) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return set()
    return {(e["path"], e["rule"], e["context"]) for e in entries}


def _apply_pragmas(index: _Index, findings: list) -> list:
    kept = []
    for f in findings:
        mod = next((m for m in index.modules.values() if m.rel == f.path), None)
        allowed: set = set()
        if mod is not None:
            for ln in (f.line, f.line - 1):
                if 1 <= ln <= len(mod.lines):
                    m = _PRAGMA_RE.search(mod.lines[ln - 1])
                    if m:
                        allowed.update(p.strip() for p in m.group(1).split(","))
        if f.rule in allowed or "all" in allowed:
            continue
        kept.append(f)
    # dedupe (nested walks may revisit a line)
    seen, out = set(), []
    for f in kept:
        k = (f.path, f.line, f.rule, f.message)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def analyze_tree(root: str | None = None) -> tuple[_Index, list, dict, list]:
    """Parse + analyze the package. Returns (index, pragma-filtered
    findings, lock-order edges, cycles)."""
    root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    index = _parse_tree(root)
    findings: list[Finding] = []
    edges, blocking_raw = _fixpoint_summaries(index)
    for rel, ln, desc, held in blocking_raw:
        mod = next((m for m in index.modules.values() if m.rel == rel), None)
        if mod is None:
            continue
        findings.append(_mk(
            mod, ln, "blocking-under-lock",
            f"blocking call {desc} while holding"
            f" {', '.join(s.rsplit('.', 1)[-1] for s in sorted(held))}",
        ))
    cycles = _find_cycles(edges)
    for cyc in cycles:
        site = edges.get((cyc[0], cyc[1]))
        mod = next(
            (m for m in index.modules.values() if site and m.rel == site[0]),
            None,
        )
        desc = " -> ".join(cyc)
        if mod is not None:
            findings.append(Finding(
                mod.rel, site[1], "lock-order-cycle",
                f"lock-order cycle: {desc}", desc,
            ))
        else:
            findings.append(Finding(
                "<package>", 1, "lock-order-cycle",
                f"lock-order cycle: {desc}", desc,
            ))
    _class_findings(index, findings)
    _global_findings(index, findings)
    _lifecycle_findings(index, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return index, _apply_pragmas(index, findings), edges, cycles


def certify_concurrency(
    root: str | None = None,
    baseline: set | None = None,
    observed_path: str | None = None,
) -> dict:
    """Run the full pass; returns the CONCURRENCY_CERT payload."""
    t0 = time.perf_counter()
    index, findings, edges, cycles = analyze_tree(root)
    baseline = load_baseline() if baseline is None else baseline
    kept = [f for f in findings if f.key() not in baseline]
    suppressed = len(findings) - len(kept)
    nodes = sorted({n for e in edges for n in e})
    observed = None
    if observed_path is None and os.path.exists(OBSERVED_DEFAULT_PATH):
        observed_path = OBSERVED_DEFAULT_PATH
    observed_stale = False
    if observed_path and os.path.exists(observed_path):
        try:
            with open(observed_path) as f:
                observed = json.load(f)
        except (OSError, ValueError):
            observed = None
        if observed is not None:
            # an observed graph from a DIFFERENT tree must not be merged:
            # a refactored acquisition order would produce a false cycle
            # (or a stale green) against the current static graph
            ohead = observed.get("head")
            head = git_head()
            if ohead and head and ohead != head:
                observed, observed_stale = None, True
    merged = merge_observed(edges, observed["edges"] if observed else [])
    merged["observed_stale_ignored"] = observed_stale
    n_threading = sum(1 for m in index.modules.values() if m.uses_threading)
    ok = not kept and not cycles and merged["ok"]
    return {
        "ok": ok,
        "pass": "concurrency",
        "n_modules_threading": n_threading,
        "n_lock_classes": len(index.lock_sites),
        "rules": dict(RULES),
        "n_findings": len(kept),
        "n_baseline_suppressed": suppressed,
        "findings": [f.as_dict() for f in kept],
        "lock_graph": {
            "nodes": nodes,
            "edges": [
                {"from": a, "to": b, "site": f"{rel}:{ln}"}
                for (a, b), (rel, ln) in sorted(edges.items())
            ],
        },
        "cycles": [" -> ".join(c) for c in cycles],
        "lockdep": merged,
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }


def write_cert(cert: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cert, f, indent=1, sort_keys=True)
        f.write("\n")


# =============================================================================
# piece 3 — runtime lockdep (install() / uninstall())
# =============================================================================


def lockdep_enabled() -> bool:
    """Whether the instrumented lock factories are installed."""
    return _state is not None


class _LockdepState:
    def __init__(self):
        self.tls = threading.local()
        self.mu = _REAL_LOCK()                 # guards the tables below
        self.edges: dict[tuple, int] = {}      # (held_id, acq_id) -> count
        self.holds: dict[str, list] = {}       # id -> [count, total_s, max_s]
        self.n_locks = 0
        self.site_map: dict[tuple, str] = {}

    def stack(self) -> list:
        st = getattr(self.tls, "stack", None)
        if st is None:
            st = self.tls.stack = []
        return st


_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition
_state: _LockdepState | None = None


def _caller_site() -> tuple | None:
    """(repo-relative path, lineno) of the first frame of this package (its
    analysis modules aside) that called the lock factory."""
    import sys

    pkg = f"{os.sep}{_PKG}{os.sep}"
    fr = sys._getframe(2)
    for _ in range(12):
        if fr is None:
            return None
        fname = fr.f_code.co_filename
        if pkg in fname and f"{pkg}analysis{os.sep}" not in fname:
            i = fname.rindex(pkg) + 1
            return fname[i:].replace(os.sep, "/"), fr.f_lineno
        fr = fr.f_back
    return None


class _InstrumentedLock:
    """Drop-in Lock/RLock wrapper recording acquisition-order edges and
    hold times into the process lockdep state."""

    def __init__(self, inner, lock_id: str, reentrant: bool):
        self._inner = inner
        self._id = lock_id
        self._reentrant = reentrant
        self._acquired_at = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def _note_acquired(self) -> None:
        st = _state
        if st is None:
            return
        stack = st.stack()
        if any(entry is self for entry, _ in stack):
            stack.append((self, True))   # reentrant re-acquire: no edge
            return
        with st.mu:
            for entry, _re in stack:
                if entry._id != self._id:
                    key = (entry._id, self._id)
                    st.edges[key] = st.edges.get(key, 0) + 1
        stack.append((self, False))
        self._acquired_at = time.perf_counter()

    def release(self):
        st = _state
        if st is not None:
            stack = st.stack()
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] is self:
                    _entry, was_reentrant = stack.pop(i)
                    if not was_reentrant:
                        dt = time.perf_counter() - self._acquired_at
                        with st.mu:
                            rec = st.holds.setdefault(self._id, [0, 0.0, 0.0])
                            rec[0] += 1
                            rec[1] += dt
                            rec[2] = max(rec[2], dt)
                    break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._inner.locked() if hasattr(self._inner, "locked") else False

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<lockdep {self._id} {self._inner!r}>"


def _make_factory(real, reentrant: bool):
    def factory():
        st = _state
        site = _caller_site()
        lock_id = None
        if st is not None and site is not None:
            lock_id = st.site_map.get(site)
        if lock_id is None:
            lock_id = f"{site[0]}:{site[1]}" if site else "<unknown>"
        if st is not None:
            with st.mu:
                st.n_locks += 1
        return _InstrumentedLock(real(), lock_id, reentrant)

    return factory


def _instrumented_condition(lock=None):
    # Condition over an instrumented lock works through the wrapper's
    # acquire/release (no _release_save shortcut — see threading.Condition)
    return _REAL_CONDITION(lock if lock is not None else threading.Lock())


def install(site_map: dict | None = None) -> None:
    """Swap the threading lock factories for instrumented ones. ``site_map``
    maps (repo-relative path, lineno) -> static lock id; when omitted it is
    computed from the static pass so runtime ids match the static graph."""
    global _state
    if _state is not None:
        return
    _state = _LockdepState()
    if site_map is None:
        index = _parse_tree(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        site_map = {
            (rel.replace(os.sep, "/"), ln): lock_id
            for (rel, ln), lock_id in index.lock_sites.items()
        }
    _state.site_map = dict(site_map)
    threading.Lock = _make_factory(_REAL_LOCK, False)
    threading.RLock = _make_factory(_REAL_RLOCK, True)
    threading.Condition = _instrumented_condition


def uninstall() -> None:
    global _state
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    _state = None


def installed() -> bool:
    return _state is not None


def reset_observed() -> None:
    if _state is not None:
        with _state.mu:
            _state.edges.clear()
            _state.holds.clear()


def observed_report() -> dict:
    """The runtime side of the cert: observed edges + hold times."""
    if _state is None:
        return {"edges": [], "holds": {}, "n_locks": 0}
    with _state.mu:
        edges = [
            {"from": a, "to": b, "count": c}
            for (a, b), c in sorted(_state.edges.items())
        ]
        holds = {
            k: {
                "acquisitions": v[0],
                "total_hold_s": round(v[1], 6),
                "max_hold_s": round(v[2], 6),
            }
            for k, v in sorted(_state.holds.items())
        }
        return {"edges": edges, "holds": holds, "n_locks": _state.n_locks}


def merge_observed(static_edges: dict, observed_edges: list) -> dict:
    """Cross-validate: merge observed acquisition-order edges into the
    static graph, re-check acyclicity, report coverage (static edges never
    seen at runtime) and runtime edges the static pass missed."""
    combined: dict[tuple, tuple] = dict(static_edges)
    obs_pairs = set()
    for e in observed_edges:
        pair = (e["from"], e["to"])
        obs_pairs.add(pair)
        combined.setdefault(pair, ("<observed>", 0))
    cycles = _find_cycles(combined)
    static_pairs = set(static_edges)
    return {
        "ok": not cycles,
        "n_static_edges": len(static_pairs),
        "n_observed_edges": len(obs_pairs),
        "observed_only_edges": sorted(
            f"{a} -> {b}" for (a, b) in obs_pairs - static_pairs
        ),
        "static_edges_unobserved": sorted(
            f"{a} -> {b}" for (a, b) in static_pairs - obs_pairs
        ),
        "merged_cycles": [" -> ".join(c) for c in cycles],
    }
