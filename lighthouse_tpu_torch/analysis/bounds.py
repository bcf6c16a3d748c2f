"""Pass 1 — the limb-bound certifier: static proofs for the limb stack.

The port of ``lighthouse_tpu/analysis/bounds.py``. The kernels' host code
already derives every bound it relies on and checks it (``fq._cert``
raises ``BoundError``): the digit schedules of the plan and chain kernels,
the lincomb budgets, the reduction walks, the launch's shared memory. This
module surfaces those proofs as an auditable certificate:

* ``ops/bls/fq.py`` has a certification sink (``fq._CERT_SINK``); with a
  ``CertSink`` installed every obligation is recorded as (kind, proven,
  declared limit).
* ``certify()`` re-executes the public op-graph surface (fq, tower, curve,
  h2c, pairing, the mesh's shard-local stages, the kernels' entries, the
  Fr limb stack, the light-client stages, the slasher and electra epoch
  sweeps) **abstractly**, on the ``meta`` device: the kernel wrappers
  record the launch's obligations and return empty outputs
  (``fused_mul.meta_fused``/``meta_chain``), so no arithmetic runs, as the
  reference runs ``jax.eval_shape``.
* The schedules, prepared plans and chain programs are cached; a cache hit
  replays the obligations its derivation recorded (``fq.certified_cache``,
  ``fused_mul.prepare_plan``), so a certificate taken in a warm process
  proves as much as the first. The import-time certificates (the budgets
  of ``fq``/``plans`` and the carry_norm schedule) are re-run explicitly.
* A ``BoundError``/``AssertionError`` raised during a graph run is not a
  certifier crash: it is recorded as an unproven edge (``unproven_bound``)
  and fails the certificate; any other exception is a ``trace_error``.

Regimes: the port has one number format (int64 limbs, caps of 2^63, the
kernels' digit schedules), so its regimes are ``cuda@b1`` and ``cuda@b32``;
there is no conv-backend axis. The certificate is written by
``python -m lighthouse_tpu_torch.analysis`` to
``lighthouse_tpu_torch/_build/analysis/BOUNDS_CERT.json``.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

__all__ = ["certify", "certify_callable", "write_cert", "CertSink", "graph_registry"]


def _bits(x: int) -> float:
    """log2 of a non-negative int, exact-ish for huge values."""
    if x <= 0:
        return 0.0
    return round(math.log2(x), 2) if x < 1 << 1000 else float(x.bit_length())


class CertSink:
    """Collects proof obligations recorded by ``fq._cert``; deduplicates
    identical (graph, kind, note, proven, limit) records into counts."""

    def __init__(self):
        self.obligations: dict[tuple, dict] = {}
        self._ctx: list[str] = []

    @property
    def graph(self) -> str:
        return "/".join(self._ctx) or "<module>"

    @contextlib.contextmanager
    def context(self, label: str):
        self._ctx.append(label)
        try:
            yield
        finally:
            self._ctx.pop()

    def record(self, kind: str, proven, limit, note: str = "", ok=None) -> None:
        proven = int(proven)
        limit = int(limit)
        if ok is None:
            ok = proven <= limit
        key = (self.graph, kind, note, proven, limit)
        rec = self.obligations.get(key)
        if rec is None:
            self.obligations[key] = {
                "graph": self.graph,
                "kind": kind,
                "site": note,
                "proven": proven,
                "limit": limit,
                "proven_bits": _bits(proven),
                "limit_bits": _bits(limit),
                "margin_bits": round(_bits(limit) - _bits(proven), 2),
                "ok": bool(ok),
                "count": 1,
            }
        else:
            rec["count"] += 1

    def fail(self, kind: str, error: str) -> None:
        """Record an unproven edge (a bound check tripped mid-run)."""
        key = (self.graph, kind, error, -1, -1)
        rec = self.obligations.setdefault(
            key,
            {"graph": self.graph, "kind": kind, "site": "", "error": error, "ok": False,
             "count": 0},
        )
        rec["count"] += 1

    def rows(self) -> list[dict]:
        return sorted(
            self.obligations.values(),
            key=lambda r: (r["ok"], r.get("margin_bits", -1.0), r["graph"]),
        )


@contextlib.contextmanager
def _sink_installed(sink: CertSink):
    from ..ops.bls import fq

    prev = fq._CERT_SINK
    fq._CERT_SINK = sink
    try:
        yield
    finally:
        fq._CERT_SINK = prev


# --------------------------------------------------------------------------------------
# Op-graph registry: the public kernel surface, per batch size
# --------------------------------------------------------------------------------------

I64, BOOL, U8, I16, I32 = torch.int64, torch.bool, torch.uint8, torch.int16, torch.int32


class Spec:
    """A tensor argument of a registry graph: shape and dtype, made on the
    run's device (``meta`` holds no data)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype=I64):
        self.shape = tuple(shape)
        self.dtype = dtype

    def make(self, device):
        return torch.zeros(self.shape, dtype=self.dtype, device=device)


def materialize(specs, device):
    """Registry arguments on ``device``: Specs become tensors, dicts and
    tuples are walked, anything else (host scalars) passes through."""
    if isinstance(specs, Spec):
        return specs.make(device)
    if isinstance(specs, dict):
        return {k: materialize(v, device) for k, v in specs.items()}
    if isinstance(specs, (tuple, list)):
        return type(specs)(materialize(v, device) for v in specs)
    return specs


def graph_registry(batch: int) -> list[tuple]:
    """(name, fn, arg-specs) for every op graph the certifier re-executes,
    under the reference's names (``lighthouse_tpu/analysis/bounds.py``)."""
    from ..bls import sharded
    from ..ops.bls import curve, fq, fused_mul as fm, h2c, pairing, plans, tower
    from ..ops.kzg import frops
    from ..ops.lc import verify as lcv
    from ..oracle.fields import BLS_X

    B = (batch,)

    def s(*shape, dtype=I64):
        return Spec(B + shape, dtype)

    e1, e2, e6, e12 = s(25), s(2, 25), s(6, 25), s(12, 25)
    p1, p2 = s(3, 25), s(6, 25)
    sc, flag = s(), s(dtype=BOOL)
    PUB = plans.PUB_BOUND

    def g(k, f):
        return functools.partial(f, k)

    return [
        # fq.py — the fused multiply, reductions, fixed chains
        ("fq.mont_mul", fq.mont_mul, (e1, e1)),
        ("fq.mont_sqr", fq.mont_sqr, (e1,)),
        ("fq.mont_mul_lazy", fq.mont_mul_lazy, (e1, e1)),
        ("fq.canonical", fq.canonical, (e1,)),
        ("fq.inv", fq.inv, (e1,)),
        ("fq.sqrt_candidate", fq.sqrt_candidate, (e1,)),
        ("fq.lex_gt_half", fq.lex_gt_half, (e1,)),
        # tower.py — fq2/fq6/fq12 plan launches and the chain programs
        ("tower.fq2_mul", tower.fq2_mul, (e2, e2)),
        ("tower.fq2_sqr", tower.fq2_sqr, (e2,)),
        ("tower.fq2_mul_lazy", tower.fq2_mul_lazy, (e2, e2)),
        ("tower.fq2_sqr_lazy", tower.fq2_sqr_lazy, (e2,)),
        ("tower.fq2_inv", tower.fq2_inv, (e2,)),
        ("tower.fq2_sqrt", tower.fq2_sqrt, (e2,)),
        ("tower.fq2_sqrt_ratio", tower.fq2_sqrt_ratio, (e2, e2)),
        ("tower.fq2_mul_many4",
         lambda a, b: tower.fq2_mul_many([(a, b), (b, a), (a, a), (b, b)]), (e2, e2)),
        ("tower.fq6_mul", tower.fq6_mul, (e6, e6)),
        ("tower.fq6_inv", tower.fq6_inv, (e6,)),
        ("tower.fq12_mul", tower.fq12_mul, (e12, e12)),
        ("tower.fq12_sqr", tower.fq12_sqr, (e12,)),
        ("tower.fq12_inv", tower.fq12_inv, (e12,)),
        ("tower.fq12_frobenius1", tower.fq12_frobenius1, (e12,)),
        ("tower.fq12_cyclotomic_sqr", tower.fq12_cyclotomic_sqr, (e12,)),
        # both |x|-power routes: the CYC_SQR/MUL12 chain program and the
        # Karabina compressed runs (bls.set_backend(karabina=...) picks)
        ("tower.fq12_cyclotomic_exp_abs_x.chain",
         lambda a: tower.fq12_cyclotomic_exp_abs_x(a, compressed=False), (e12,)),
        ("tower.fq12_cyclotomic_exp_abs_x.karabina",
         lambda a: tower.fq12_cyclotomic_exp_abs_x(a, compressed=True), (e12,)),
        ("tower.fq12_mul_lazy", tower.fq12_mul_lazy, (e12, e12)),
        ("tower.fq12_sqr_lazy", tower.fq12_sqr_lazy, (e12,)),
        ("tower.fq12_cyclotomic_sqr_lazy", tower.fq12_cyclotomic_sqr_lazy, (e12,)),
        ("tower.fq12_compressed_sqr", tower.fq12_compressed_sqr, (s(8, 25),)),
        ("tower.fq12_compressed_sqr_lazy", tower.fq12_compressed_sqr_lazy, (s(8, 25),)),
        ("tower.fq12_decompress", tower.fq12_decompress, (s(8, 25),)),
        ("tower.t_eq12", tower.t_eq, (e12, e12)),
        # curve.py — complete formulas, scalar multiplication
        ("curve.point_add.g1", g(1, curve.point_add), (p1, p1)),
        ("curve.point_dbl.g1", g(1, curve.point_dbl), (p1,)),
        ("curve.point_add.g2", g(2, curve.point_add), (p2, p2)),
        ("curve.point_dbl.g2", g(2, curve.point_dbl), (p2,)),
        ("curve.point_eq.g2", g(2, curve.point_eq), (p2, p2)),
        ("curve.to_affine.g2", g(2, curve.to_affine), (p2,)),
        ("curve.scale_fixed_x.g2", lambda p: curve.scale_fixed(2, p, BLS_X), (p2,)),
        ("curve.scale_u64_with_fixed.g2",
         lambda p, r: curve.scale_u64_with_fixed(2, p, r, (-BLS_X,)), (p2, sc)),
        # h2c.py — SSWU fraction form, isogeny, cofactor clearing
        ("h2c.map_to_g2", h2c.map_to_g2, (e2, e2)),
        # pairing.py — the sparse line products, the planned Miller loop
        # (per row: a product over a one-pair axis), the shared-accumulator
        # product, the final exponentiation
        ("pairing.mul_by_014",
         lambda f, c: plans.execute(pairing.MUL_BY_014, f, c, PUB, PUB, "mul014"), (e12, e6)),
        ("pairing.mul_by_01245",
         lambda f, c: plans.execute(pairing.MUL_BY_01245, f, c, PUB, PUB, "mul01245"),
         (e12, s(10, 25))),
        ("pairing.miller_loop",
         lambda px, py, qx, qy: pairing.miller_loop_product(px[None], py[None], qx[None], qy[None]),
         (e1, e1, e2, e2)),
        ("pairing.miller_loop_product", pairing.miller_loop_product, (e1, e1, e2, e2)),
        ("pairing.final_exponentiation", pairing.final_exponentiation, (e12,)),
        ("pairing.fq12_prod3",
         lambda a, b, c: sharded.fq12_prod(torch.stack([a, b, c])), (e12, e12, e12)),
        # bls/sharded.py — what each device of the serving mesh runs per
        # shard (the reference's tpu_backend shard-local bodies)
        ("tpu_backend.shard_local_prep", sharded.local_prep_partials,
         (Spec((64, 3, 25)), s(4), s(4, dtype=BOOL), e1, e1, sc, flag, sc, flag)),
        ("tpu_backend.shard_local_pair_verdict", sharded.local_pair_verdict,
         (s(1, 25), s(1, 25), e2, e2, Spec((6, 25)), Spec((), BOOL), flag)),
        # ops/bls/fused_mul.py — the kernels' entries by name: K1, K2 and K3
        # (MUL12; CYC_SQR's pass-through rows at the F12 out bound; FROB12's
        # constant pool)
        ("pallas.fused_mul", lambda a, b: fm.fused_mul(a, b, lazy=False), (e1, e1)),
        ("pallas.fused_mul_lazy", lambda a, b: fm.fused_mul(a, b, lazy=True), (e1, e1)),
        ("pallas.execute_fq12_mul",
         lambda a, b: fm.execute_plan(plans.MUL12, a, b, PUB, PUB, "fq12_mul"), (e12, e12)),
        ("pallas.execute_cyc_sqr_lazy",
         lambda a: fm.execute_plan(plans.CYC_SQR, a, a, plans.F12_BOUND, plans.F12_BOUND,
                                   "cyc_sqr_c", plans.F12_BOUND), (e12,)),
        ("pallas.execute_frob12",
         lambda a: fm.execute_plan(plans.FROB12, a, a, PUB, PUB, "frob12"), (e12,)),
        # ops/kzg/frops.py — the Fr limb stack of the PeerDAS cell engine
        ("kzg.fr_mul", frops.fr_mul, (e1, e1)),
        ("kzg.fr_dot", frops.fr_dot, (s(4, 25), s(4, 25))),
        ("kzg.fr_weighted_sum", lambda w, u: frops.fr_weighted_sum(w, u, batch), (e1, e1)),
        ("kzg.fr_wide_reduce", lambda t: frops.fr_wide_reduce(t, frops.R2_INT), (s(49),)),
        ("kzg.fr_bits", frops.fr_bits, (e1,)),
        # ops/lc/verify.py — the light-client stages and their composition;
        # a small committee (C = 8): the bound walk is per lane
        ("lc.h2c", lcv.lc_h2c, (e2, e2)),
        ("lc.prep", lcv.lc_prep,
         (Spec((4, 8, 3, 25)), sc, s(8, dtype=BOOL), e1, e1, sc, flag, sc, flag)),
        ("lc.pair", lcv.lc_pair,
         (s(1, 25), s(1, 25), Spec((2, 25)), Spec((2, 25)), e2, e2, flag, flag)),
        ("lc.batch_check", lcv.lc_batch_check,
         (Spec((4, 8, 3, 25)), sc, s(8, dtype=BOOL), e2, e2, e1, e1, sc, flag, sc, flag)),
        # slasher/kernels.py — the span sweep over [256, 64] planes (on the
        # CPU: torch.unique has no meta kernel, its output shape is data's)
        ("slasher.sweep", _slasher_sweep_graph,
         ((Spec((256, 64), I16), Spec((256, 64), I16), Spec((256, 64), I32)),
          Spec((batch * 4,)), Spec((batch * 4,), I32), Spec((batch * 4,), I32),
          Spec((batch * 4,)), Spec((batch * 4,), BOOL))),
        # epoch_engine/kernels.py — the electra sweep at the 256 bucket, and
        # the engine's per-sweep int64 headroom proof at its worst values
        ("epoch.sweep_electra", _epoch_sweep_graph(), (_epoch_cols(),)),
    ]


def _slasher_sweep_graph(planes, vidx, src, tgt, vh, valid):
    from ..slasher import kernels

    if vidx.device.type == "meta":
        planes = [torch.zeros_like(p, device="cpu") for p in planes]
        vidx, src, tgt, vh, valid = (
            torch.zeros_like(x, device="cpu") for x in (vidx, src, tgt, vh, valid)
        )
    return kernels.sweep_(list(planes), 0, vidx, src, tgt, vh, valid, 64, n=64)


_EPOCH_N = 256


def _epoch_cols() -> dict:
    v = Spec((_EPOCH_N,))
    vb = Spec((_EPOCH_N,), BOOL)
    vu8 = Spec((_EPOCH_N,), U8)
    return {
        "effective": v, "slashed": vb, "activation": v, "exit": v, "withdrawable": v,
        "eligibility": v, "compounding": vb, "balances": v, "inactivity": v,
        "prev_part": vu8, "cur_part": vu8,
        "dep_amount": Spec((16,)), "dep_slot": Spec((16,)), "dep_index": Spec((16,)),
        "dep_valid": Spec((16,), BOOL),
        "con_src": Spec((8,)), "con_tgt": Spec((8,)), "con_valid": Spec((8,), BOOL),
    }


def _epoch_sweep_graph():
    import numpy as np

    from ..epoch_engine import kernels
    from ..ops.bls.fq import _cert
    from ..types.spec import mainnet_spec

    spec = mainnet_spec(
        altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
        deneb_fork_epoch=0, electra_fork_epoch=0,
    )
    consts = kernels.consts_for(spec, "electra")
    scalars = {
        "cur_epoch": 5, "finalized_epoch": 3, "prev_justified_epoch": 3,
        "cur_justified_epoch": 4, "bits": [True, True, False, False], "slash_sum": 0,
        "earliest_exit_epoch": 10, "exit_balance_to_consume": 0,
        "deposit_balance_to_consume": 0, "eth1_deposit_index": _EPOCH_N,
        "deposit_requests_start_index": 2**64 - 1,
    }

    def graph(cols):
        # the engine's per-sweep proof (epoch_engine/engine.py), at the
        # registry extent with every validator active at the electra cap
        top = np.full(_EPOCH_N, consts.max_effective_balance_electra, np.uint64)
        bound = kernels.sweep_headroom(
            consts, top, np.ones(_EPOCH_N, bool), top, np.zeros(_EPOCH_N, np.uint64),
            0, scalars["cur_epoch"], np.zeros(16, np.uint64), 0,
        )
        _cert("epoch_churn_cumsum_headroom", bound, kernels.I64_MAX, "registry extent")
        return kernels.run_sweep(consts, cols, dict(scalars))

    return graph


# --------------------------------------------------------------------------------------
# The abstract run: meta tensors, the pointwise ops' shapes computed here
# --------------------------------------------------------------------------------------

# torch's meta kernels for pointwise ops are Python reference
# implementations (torch/_meta_registrations.py), ~0.1-0.2 ms each: most of
# an abstract run. For the functional pointwise ops and factories below the
# result is a broadcast shape and a promoted dtype, computed here directly;
# every other op (views, reductions, indexing, mutation) runs its own meta
# kernel. Obligations are recorded by host code, so they cannot differ; the
# shapes and dtypes are held equal to the meta kernels' by the tests.
_PROMOTE = (
    "add.Tensor", "add.Scalar", "sub.Tensor", "sub.Scalar", "mul.Tensor", "mul.Scalar",
    "bitwise_and.Tensor", "bitwise_and.Scalar", "bitwise_or.Tensor", "bitwise_or.Scalar",
    "bitwise_xor.Tensor", "bitwise_xor.Scalar", "__rshift__.Scalar", "__rshift__.Tensor",
    "__lshift__.Scalar", "__lshift__.Tensor", "bitwise_left_shift.Tensor",
    "bitwise_right_shift.Tensor", "minimum.default", "maximum.default", "remainder.Scalar",
    "remainder.Tensor",
)
_SAME = ("neg.default", "bitwise_not.default", "abs.default")
_BOOL = (
    "eq.Tensor", "eq.Scalar", "ne.Tensor", "ne.Scalar", "gt.Tensor", "gt.Scalar",
    "ge.Tensor", "ge.Scalar", "lt.Tensor", "lt.Scalar", "le.Tensor", "le.Scalar",
    "logical_and.default", "logical_or.default", "logical_not.default",
)
_FAST_OPS: dict = {}


def _fast_ops() -> dict:
    if not _FAST_OPS:
        aten = torch.ops.aten
        for kind, names in (("promote", _PROMOTE), ("same", _SAME), ("bool", _BOOL)):
            for n in names:
                op, _, overload = n.partition(".")
                _FAST_OPS[getattr(getattr(aten, op), overload)] = kind
        _FAST_OPS[aten.where.self] = "where"
        _FAST_OPS[aten.cat.default] = "cat"
        _FAST_OPS[aten.zeros_like.default] = "like"
        _FAST_OPS[aten.ones_like.default] = "like"
        _FAST_OPS[aten.new_zeros.default] = "new"
    return _FAST_OPS


def _promote(values):
    """The promoted dtype of one tensor, or of two operands (tensors or
    Python numbers); None for anything else (the meta kernel decides)."""
    vals = [v for v in values if isinstance(v, (torch.Tensor, bool, int, float))]
    if len(vals) == 1 and isinstance(vals[0], torch.Tensor):
        return vals[0].dtype
    if len(vals) == 2:
        return torch.result_type(vals[0], vals[1])
    return None


def _meta_result(func, args, kwargs):
    """The output of ``func`` on meta tensors computed without its meta
    kernel, or None when ``func`` is not one of the fast ops (or its call
    is not the plain functional form)."""
    kind = _fast_ops().get(func)
    if kind is None:
        return None
    if kind == "cat":
        ts = [t for t in args[0] if not (t.dim() == 1 and t.numel() == 0)]
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        if not ts or kwargs.keys() - {"dim"} or any(t.device.type != "meta" for t in ts):
            return None
        dim = dim % ts[0].dim()
        shape = list(ts[0].shape)
        shape[dim] = sum(t.shape[dim] for t in ts)
        dtype = ts[0].dtype
        for t in ts[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        return torch.empty(shape, dtype=dtype, device="meta")
    if kind == "like":
        x = args[0]
        if x.device.type != "meta" or len(args) > 1 or kwargs.keys() - {"dtype", "memory_format"}:
            return None
        return torch.empty(x.shape, dtype=kwargs.get("dtype") or x.dtype, device="meta")
    if kind == "new":
        x, size = args[0], args[1]
        if x.device.type != "meta" or len(args) > 2 or kwargs.keys() - {"dtype"}:
            return None
        return torch.empty(tuple(size), dtype=kwargs.get("dtype") or x.dtype, device="meta")
    if kwargs:
        return None
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if not ts or any(t.device.type != "meta" for t in ts):
        return None
    shape = ts[0].shape if len(ts) == 1 else torch.broadcast_shapes(*(t.shape for t in ts))
    if kind == "bool":
        dtype = torch.bool
    elif kind == "same":
        dtype = ts[0].dtype
    else:
        dtype = _promote(args[1:] if kind == "where" else args)
        if dtype is None:
            return None
    return torch.empty(shape, dtype=dtype, device="meta")


@functools.cache
def _abstract_mode_cls():
    from torch.utils._python_dispatch import TorchDispatchMode

    class AbstractMode(TorchDispatchMode):
        """Runs the fast ops' shapes here and every other op as it is."""

        def run(self, func, args, kwargs):
            out = _meta_result(func, args, kwargs or {})
            return func(*args, **(kwargs or {})) if out is None else out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return self.run(func, args, kwargs)

    return AbstractMode


# Batch regimes: bound propagation is shape-dependent (broadcast axes reach
# the lincomb and cluster choices), so a scalar-ish and a wide regime.
_DEFAULT_BATCHES = (1, 32)
REGIME = "cuda"


def _trace_graph(sink: CertSink, name: str, fn, specs, device="meta") -> None:
    with sink.context(name):
        try:
            with _abstract_mode_cls()():
                fn(*materialize(specs, device))
        except AssertionError as e:  # fq.BoundError included
            sink.fail("unproven_bound", str(e) or "AssertionError")
        except Exception as e:  # noqa: BLE001 — a broken graph is a finding
            sink.fail("trace_error", f"{type(e).__name__}: {e}")


def certify_callable(fn, specs, device="meta") -> list[dict]:
    """Certify ONE callable's bound obligations (fixture corpus, mutation
    tests): run it on ``device`` (``meta`` by default) under a sink."""
    sink = CertSink()
    with _sink_installed(sink):
        _trace_graph(sink, getattr(fn, "__name__", "callable"), fn, specs, device)
    return sink.rows()


def _import_certs(sink: CertSink) -> None:
    """The certificates proved at import (the budgets of fq and plans, the
    carry_norm schedule), re-run into the sink."""
    from ..ops.bls import fq, plans

    for label, fn in (("fq.import_certs", fq._import_certs),
                      ("plans.import_certs", plans._import_certs)):
        with sink.context(label):
            try:
                fn()
            except AssertionError as e:
                sink.fail("unproven_bound", str(e))


def certify(batches=_DEFAULT_BATCHES, graphs=None) -> dict:
    """Run the certificate: every registry graph x batch regime, on the meta
    device. ``graphs`` optionally restricts to names containing any of the
    given substrings. Returns the certificate dict (see ``write_cert``)."""
    graph_registry(1)  # imports the graphs' modules: their import-time proofs stay out
    sink = CertSink()
    with _sink_installed(sink):
        _import_certs(sink)
        for batch in batches:
            regime = f"{REGIME}@b{batch}"
            for name, fn, specs in graph_registry(batch):
                if graphs and not any(s in name for s in graphs):
                    continue
                _trace_graph(sink, f"{regime}/{name}", fn, specs)
    return cert_from_sink(sink, batches)


def cert_from_sink(sink: CertSink, batches) -> dict:
    """The certificate of what ``sink`` recorded (``certify``, or the memory
    pass's walk of the same registry run, ``memory.certify_memory(sink=)``)."""
    from ..ops.bls import fused_mul

    rows = sink.rows()
    failed = [r for r in rows if not r["ok"]]
    margins = [r["margin_bits"] for r in rows if "margin_bits" in r]
    return {
        "version": 1,
        "tool": "python -m lighthouse_tpu_torch.analysis --bounds",
        "regime": REGIME,
        "batches": list(batches),
        "smem_limit": fused_mul.SMEM_LIMIT,
        "ok": not failed,
        "n_obligations": len(rows),
        "n_failed": len(failed),
        "min_margin_bits": min(margins) if margins else None,
        "obligations": rows,
    }


def write_cert(cert: dict, path: str) -> None:
    import json
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cert, f, indent=1)
        f.write("\n")
