"""Pass 2 — the host-sync linter: AST checks for the device path's stalls.

The port of ``lighthouse_tpu/analysis/hygiene.py``, rewritten for eager
PyTorch. The reference lints *jit scopes*: code JAX traces once, where a
host sync or a Python branch on a tracer is a bug. The port traces nothing:
every line of the device path runs eagerly, each time, so the hazard is a
stall, not a bug — a device-to-host read blocks the calling thread until
the card drains its queue, and a Python branch on a tensor is such a read.
The rules that keep a meaning, over every function of the device-path
modules (``SCOPE``):

* ``host-sync`` — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``
  calls, and ``int()``/``float()``/``bool()`` of a tensor;
* ``tensor-branch`` — a Python ``if``/``while`` whose test reads a tensor
  (``.shape``/``.dtype``/``.device``/``.ndim`` reads and ``len``/
  ``isinstance`` are host facts and exempt);
* ``cache-unhashable`` — a list, dict, set, numpy array or tensor passed to
  a function decorated with ``functools.lru_cache`` or
  ``fq.certified_cache`` (the schedule builders): it raises ``TypeError``
  at the call.

A value is a tensor when it comes from a ``torch.*`` call (other than the
dtype and device helpers), from a tensor's method, from arithmetic or
indexing of a tensor, or is a parameter annotated ``torch.Tensor``; the
propagation is forward, statement by statement, as the reference's taint.

Rules with no counterpart: ``static-unhashable`` (no ``static_argnums``:
nothing is compiled per argument value) and ``impure-closure`` (no trace:
a side effect in a device-path function runs every call, as written).

Intentional sites carry a ``# lint: allow(<rule>)`` pragma on the flagged
line (or the line above) with its reason; whole findings can live in the
checked-in baseline (``analysis/hygiene_baseline.json``, keyed by (path,
rule, source line)), which is empty.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass

__all__ = ["Finding", "lint_file", "lint_tree", "RULES", "SCOPE", "load_baseline"]

RULES = {
    "host-sync": "device-to-host read on the device path",
    "tensor-branch": "Python control flow on a tensor",
    "cache-unhashable": "unhashable value passed to a cached builder",
}

# the device-path modules, relative to the package root (a directory means
# every module under it)
SCOPE = (
    "ops",
    "bls/backend.py",
    "bls/sharded.py",
    "bls/mesh.py",
    "epoch_engine/kernels.py",
    "epoch_engine/sharded.py",
    "slasher/kernels.py",
    "kzg/msm.py",
    "light_client/engine.py",
)

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([a-z\-,\s]+)\)")
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_HOST_CAST_FNS = {"float", "int", "bool", "complex"}
# torch functions that return host values, not tensors
_TORCH_HOST = {
    "device", "dtype", "Size", "is_tensor", "get_num_threads", "broadcast_shapes",
    "iinfo", "finfo", "cuda", "no_grad", "inference_mode",
}
# tensor methods that return host values (no device read)
_HOST_METHODS = {
    "data_ptr", "stride", "size", "dim", "numel", "element_size", "is_contiguous",
    "storage_offset", "get_device", "untyped_storage",
}
_CACHE_DECORATORS = {"lru_cache", "cache", "certified_cache"}
_NP_NAMES = {"np", "numpy"}


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str
    context: str  # stripped source line (the baseline key)

    def key(self) -> tuple:
        return (self.path, self.rule, self.context)

    def as_dict(self) -> dict:
        return {
            "path": self.path, "line": self.line, "rule": self.rule,
            "message": self.message, "context": self.context,
        }

    def __str__(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.rule}] {self.message}\n"
            f"    {self.context}\n"
            f"    (intentional? append  # lint: allow({self.rule}))"
        )


def _dotted(node) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_tensor_annotation(ann) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann)
    return "Tensor" in text


class _Tensors(ast.NodeVisitor):
    """Does an expression produce (or read) a tensor? Collects the tensor
    names it reads, skipping host facts (``x.shape``, ``len(x)``)."""

    def __init__(self, tensors: set[str]):
        self.tensors = tensors
        self.hits: list[str] = []

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in _STATIC_ATTRS:
            return
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        # `x is None` / `x is not None`: an identity test, not a read
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Name) and f.id in (
            "len", "isinstance", "type", "getattr", "hasattr", "range", "id",
            *_HOST_CAST_FNS,
        ):
            return  # host facts, and host values of a read (flagged at the read)
        if isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS:
            return
        d = _dotted(f)
        if d is not None and d.startswith("torch."):
            tail = d.split(".")[1]
            if tail not in _TORCH_HOST:
                self.hits.append(d)
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            return  # the result of a host read is a host value
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if node.id in self.tensors:
            self.hits.append(node.id)


def _tensor_uses(expr, tensors: set[str]) -> list[str]:
    v = _Tensors(tensors)
    v.visit(expr)
    return v.hits


class _FunctionLint:
    """The rules over one function body, with forward tensor propagation."""

    def __init__(self, fname: str, findings: list, path: str, lines: list[str],
                 cached: set[str]):
        self.fname = fname
        self.findings = findings
        self.path = path
        self.lines = lines
        self.cached = cached

    def flag(self, node, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 1)
        ctx = self.lines[line - 1].strip() if line <= len(self.lines) else ""
        self.findings.append(Finding(self.path, line, rule, message, ctx))

    def run(self, fn) -> None:
        tensors = {
            a.arg for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
            if _is_tensor_annotation(a.annotation)
        }
        self._walk(fn.body, tensors)

    def _walk(self, stmts, tensors: set[str]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # linted as their own functions (closures see no taint)
            if isinstance(st, (ast.If, ast.While)):
                hits = _tensor_uses(st.test, tensors)
                if hits:
                    self.flag(
                        st, "tensor-branch",
                        f"Python `{'if' if isinstance(st, ast.If) else 'while'}` on"
                        f" tensor(s) {sorted(set(hits))} in {self.fname} (a host read;"
                        " use torch.where, or read once and say so)",
                    )
                self._scan(st.test, tensors)
                self._walk(st.body, tensors)
                self._walk(st.orelse, tensors)
                continue
            if isinstance(st, (ast.For, ast.AsyncFor)):
                self._scan(st.iter, tensors)
                if _tensor_uses(st.iter, tensors):
                    self._bind(st.target, tensors, True)
                self._walk(st.body, tensors)
                self._walk(st.orelse, tensors)
                continue
            if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = st.value
                if value is None:
                    continue
                self._scan(value, tensors)
                is_t = bool(_tensor_uses(value, tensors))
                targets = st.targets if isinstance(st, ast.Assign) else [st.target]
                for tgt in targets:
                    if isinstance(st, ast.AugAssign):
                        if is_t:
                            self._bind(tgt, tensors, True)
                    else:
                        self._bind(tgt, tensors, is_t)
                continue
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._scan(child, tensors)
                elif isinstance(child, ast.stmt):
                    self._walk([child], tensors)
                elif isinstance(child, ast.excepthandler):
                    self._walk(child.body, tensors)
                elif isinstance(child, ast.withitem):
                    self._scan(child.context_expr, tensors)

    @staticmethod
    def _bind(tgt, tensors: set[str], is_t: bool) -> None:
        if isinstance(tgt, ast.Name):
            if is_t:
                tensors.add(tgt.id)
            else:
                tensors.discard(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                _FunctionLint._bind(el, tensors, is_t)
        elif isinstance(tgt, ast.Starred):
            _FunctionLint._bind(tgt.value, tensors, is_t)

    def _scan(self, expr, tensors: set[str]) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS and not (
                fn.attr in ("item", "tolist") and not _tensor_uses(fn.value, tensors)
                and _is_numpy_expr(fn.value)
            ):
                self.flag(
                    node, "host-sync",
                    f".{fn.attr}() reads the device in {self.fname}",
                )
            elif (
                isinstance(fn, ast.Name)
                and fn.id in _HOST_CAST_FNS
                and any(_tensor_uses(a, tensors) for a in node.args)
            ):
                self.flag(
                    node, "host-sync",
                    f"{fn.id}() of a tensor in {self.fname} (a device-to-host read)",
                )
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if name in self.cached:
                for a in list(node.args) + [kw.value for kw in node.keywords]:
                    if _unhashable(a, tensors):
                        self.flag(
                            a, "cache-unhashable",
                            f"unhashable argument to the cached builder {name}()"
                            " (raises TypeError at the call)",
                        )


def _is_numpy_expr(node) -> bool:
    """``np.something(...)`` or ``np.something(...).attr``: a host array."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        return d is not None and d.split(".")[0] in _NP_NAMES
    return False


def _unhashable(node, tensors: set[str]) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                         ast.SetComp)):
        return True
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        if d is None:
            return False
        head, tail = d.split(".")[0], d.split(".")[-1]
        return (
            (head in _NP_NAMES and tail in ("array", "asarray", "zeros", "ones"))
            or d in ("list", "dict", "set", "bytearray")
            or (head == "torch" and tail not in _TORCH_HOST)
        )
    return False


def cached_names(tree) -> set[str]:
    """Names of the module's functions decorated with a cache."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                d = _dotted(target) or ""
                if d.split(".")[-1] in _CACHE_DECORATORS:
                    out.add(node.name)
    return out


def lint_file(path: str, rel: str | None = None, cached: set[str] | None = None) -> list[Finding]:
    """Lint one module; ``cached`` names the cached builders callable from
    it (default: the module's own)."""
    with open(path) as f:
        src = f.read()
    rel = rel or path
    lines = src.splitlines()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, "host-sync", f"unparseable: {e}", "")]
    cached = cached_names(tree) if cached is None else cached
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _FunctionLint(node.name, findings, rel, lines, cached).run(node)
    # module-level statements
    top = [n for n in tree.body if not isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    _FunctionLint("<module>", findings, rel, lines, cached)._walk(top, set())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    kept = []
    for f in findings:
        allowed = set()
        for ln in (f.line, f.line - 1):
            if 1 <= ln <= len(lines):
                m = _PRAGMA_RE.search(lines[ln - 1])
                if m:
                    allowed.update(p.strip() for p in m.group(1).split(","))
        if f.rule in allowed or "all" in allowed:
            continue
        kept.append(f)
    seen, out = set(), []
    for f in kept:  # one finding per line and rule
        k = (f.path, f.line, f.rule)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


_BASELINE_PATH = os.path.join(os.path.dirname(__file__), "hygiene_baseline.json")


def load_baseline(path: str | None = None) -> set[tuple]:
    path = path or _BASELINE_PATH
    try:
        with open(path) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return set()
    return {(e["path"], e["rule"], e["context"]) for e in entries}


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scope_files(root: str, scope=SCOPE) -> list[str]:
    """The .py files of ``scope`` under ``root`` (a directory entry means
    every module under it; a missing entry is skipped)."""
    files = []
    for entry in scope:
        full = os.path.join(root, entry)
        if os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
                files += [os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")]
        elif os.path.isfile(full):
            files.append(full)
    return files


def lint_tree(
    root: str | None = None, baseline: set | None = None, scope=SCOPE
) -> tuple[list[Finding], int]:
    """Lint the device-path modules of ``root`` (default: this package).
    Returns (findings not in the baseline, count suppressed by baseline)."""
    root = root or _package_root()
    baseline = load_baseline() if baseline is None else baseline
    files = scope_files(root, scope)
    cached: set[str] = set()
    for full in files:
        try:
            with open(full) as f:
                cached |= cached_names(ast.parse(f.read()))
        except (OSError, SyntaxError):
            continue
    findings: list[Finding] = []
    for full in files:
        rel = os.path.relpath(full, os.path.dirname(root))
        findings.extend(lint_file(full, rel, cached))
    kept = [f for f in findings if f.key() not in baseline]
    return kept, len(findings) - len(kept)
