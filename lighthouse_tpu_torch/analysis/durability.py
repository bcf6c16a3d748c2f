"""Durability lint — pass 2's crash-safety rider.

The port of ``lighthouse_tpu/analysis/durability.py``, the same rule over
the port's tree. One rule, ``torn-write``: a function that issues **two or
more** raw key-value mutations (``.put`` / ``.delete`` on a store-shaped
receiver, or the ``HotColdDB`` single-key helpers) is a multi-key
persistence sequence a kill can tear in half — such sequences go through
ONE ``do_atomically`` batch (or the purpose-built atomic helpers
``atomic_block_import`` / ``store_cold_state`` / ``put_state``). A mutation
inside a loop counts double: a loop of single puts is the canonical torn
sequence even though it is one call site.

Scope is the persistence-bearing packages on the block-import and
finalization paths (``store/``, ``beacon_chain/``, ``op_pool/``,
``fork_choice/``, ``slasher/``) minus ``store/kv.py`` itself — the WAL
backend *implements* the atomicity contract; everything above it must use
it. Heuristic, like every lint here: receivers are matched textually
(``self.hot``, ``store.cold``, ``self.store`` ...), so helper indirection
can evade it.

Intentional sites carry ``# lint: allow(torn-write)`` on the function's
``def`` line (or the line above) with a justification; whole-finding
exceptions live in ``analysis/durability_baseline.json`` (same key scheme
as the hygiene baseline; checked in empty).
"""

from __future__ import annotations

import ast
import json
import os

from .hygiene import _PRAGMA_RE, Finding

__all__ = ["RULE", "lint_file", "lint_tree", "load_baseline"]

RULE = "torn-write"

# persistence-bearing packages relative to the package root
_SCOPE = (
    "store",
    "beacon_chain",
    "op_pool",
    "fork_choice",
    "slasher",
)
# the WAL backend itself (implements the contract) is out of scope
_EXEMPT_FILES = ("store/kv.py",)
# functions that ARE the atomic seam
_EXEMPT_FUNCS = {"do_atomically"}

_MUTATION_ATTRS = {
    "put",
    "delete",
    "put_block",
    "put_state",
    "delete_block",
    "delete_state",
    "put_meta",
    "put_blob_sidecars",
    "delete_blob_sidecars",
}
_RECEIVER_HINTS = ("store", "hot", "cold", "db")


def _receiver_is_store(node: ast.AST) -> bool:
    try:
        text = ast.unparse(node).lower()
    except Exception:  # noqa: BLE001 — exotic receiver: be conservative
        return False
    return any(h in text for h in _RECEIVER_HINTS) or text == "self"


def _mutations(fn: ast.AST):
    """Yield (call_node, weight) for raw KV mutations in ``fn``'s own body
    (nested defs are linted as their own functions). Weight 2 inside a
    loop — a looped single-key write is a multi-key sequence."""
    nested = {
        id(sub)
        for sub in ast.walk(fn)
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
        and sub is not fn
    }

    def walk(node, in_loop, owned):
        for child in ast.iter_child_nodes(node):
            if id(child) in nested:
                continue
            child_loop = in_loop or isinstance(
                child, (ast.For, ast.While, ast.AsyncFor)
            )
            if (
                isinstance(child, ast.Call)
                and isinstance(child.func, ast.Attribute)
                and child.func.attr in _MUTATION_ATTRS
                and _receiver_is_store(child.func.value)
            ):
                owned.append((child, 2 if child_loop else 1))
            walk(child, child_loop, owned)

    owned: list = []
    walk(fn, False, owned)
    return owned


def lint_file(path: str, rel: str | None = None) -> list[Finding]:
    with open(path) as f:
        src = f.read()
    rel = rel or path
    lines = src.splitlines()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, RULE, f"unparseable: {e}", "")]
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name in _EXEMPT_FUNCS:
            continue
        muts = _mutations(node)
        weight = sum(w for _, w in muts)
        if weight < 2:
            continue
        context = (
            lines[node.lineno - 1].strip()
            if node.lineno <= len(lines)
            else node.name
        )
        looped = any(w == 2 for _, w in muts)
        findings.append(
            Finding(
                rel,
                node.lineno,
                RULE,
                f"{len(muts)} raw KV mutation(s)"
                f"{' (looped)' if looped else ''} in one function — a crash "
                "mid-sequence tears it; batch them in one do_atomically",
                context,
            )
        )
    # pragma suppression: the def line or the line above
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
    return kept


_BASELINE_PATH = os.path.join(
    os.path.dirname(__file__), "durability_baseline.json"
)


def load_baseline(path: str | None = None) -> set[tuple]:
    path = path or _BASELINE_PATH
    try:
        with open(path) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return set()
    return {(e["path"], e["rule"], e["context"]) for e in entries}


def lint_tree(
    root: str | None = None, baseline: set | None = None
) -> tuple[list[Finding], int]:
    """Lint the persistence scope. Returns (findings not in the baseline,
    count suppressed by baseline) — the shape of ``hygiene.lint_tree``."""
    root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    baseline = load_baseline() if baseline is None else baseline
    findings: list[Finding] = []
    for sub in _SCOPE:
        base = os.path.join(root, sub)
        if os.path.isdir(base):
            files = [
                os.path.join(base, fn)
                for fn in sorted(os.listdir(base))
                if fn.endswith(".py")
            ]
        elif os.path.isfile(base + ".py"):
            files = [base + ".py"]
        else:
            continue
        for full in files:
            rel = os.path.relpath(full, os.path.dirname(root))
            if any(rel.replace(os.sep, "/").endswith(e) for e in _EXEMPT_FILES):
                continue
            findings.extend(lint_file(full, rel))
    findings.sort(key=lambda f: (f.path, f.line))
    kept = [f for f in findings if f.key() not in baseline]
    return kept, len(findings) - len(kept)
