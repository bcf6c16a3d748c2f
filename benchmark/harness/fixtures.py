"""Keys and signatures made from the configuration and the seed.

Everything here runs on the host in pure Python, on the frozen arithmetic
of ``benchmark/reference``: nothing of the program signs or derives a key.

* The registry: validator ``v`` holds the secret key ``sk0 + v``; its
  public keys are walked as pk_{v+1} = pk_v + G (one mixed Jacobian add a
  key, one batched normalisation a chunk) and kept as raw affine bytes
  [n, 96] in the benchmark's cache directory after the first build.
* Signatures over a message that many signers share (a slot's attestation
  data root, its selection-proof root): with consecutive secret keys the
  signature of a set of validators S is (|S| * sk0 + sum(S)) * H(m), so a
  ``SharedSigner`` keeps j * (sk0 * H(m)) for j <= the widest set and
  j * 2^(10 w) * H(m) for 10-bit windows w, and signs with a handful of
  Jacobian adds. Signatures over distinct messages pay hash_to_curve and a
  scalar multiplication each.

Jobs are plain tuples so that worker processes can run them.
"""

from __future__ import annotations

import os

import numpy as np

from ..reference import curves as oc
from ..reference.bls import DST
from ..reference.fields import P, R
from ..reference.hash_to_curve import hash_to_curve_g2

REGISTRY_CHUNKS = 8  # independent walks of the registry, one per worker
WINDOW_BITS = 10


# -- the registry -----------------------------------------------------------------


def registry_walk(job):
    """Affine pubkeys of secret keys sk .. sk+m-1 as raw [m, 96] bytes: one
    mixed Jacobian + affine G addition per key, then one batched
    normalisation (Montgomery's trick)."""
    sk, n = job
    gx, gy = oc.g1_generator()
    x1, y1 = oc.g1_mul((gx, gy), sk)
    X, Y, Z = [x1], [y1], [1]
    for _ in range(n - 1):
        # mixed Jacobian + affine G addition (add-2007-bl madd, a = 0)
        x, y, z = X[-1], Y[-1], Z[-1]
        zz = z * z % P
        u2 = gx * zz % P
        s2 = gy * z % P * zz % P
        h = (u2 - x) % P
        if h == 0:
            raise ValueError("registry walk hit the generator")
        hh = h * h % P
        i4 = 4 * hh % P
        j = h * i4 % P
        r = 2 * (s2 - y) % P
        v = x * i4 % P
        x3 = (r * r - j - 2 * v) % P
        y3 = (r * (v - x3) - 2 * y * j) % P
        z3 = ((z + h) * (z + h) - zz - hh) % P
        X.append(x3)
        Y.append(y3)
        Z.append(z3)
    pref = [0] * n
    acc = 1
    for i in range(n):
        acc = acc * Z[i] % P
        pref[i] = acc
    inv = pow(acc, P - 2, P)
    out_x = [0] * n
    out_y = [0] * n
    for i in range(n - 1, -1, -1):
        zi = inv * pref[i - 1] % P if i else inv
        inv = inv * Z[i] % P
        zi2 = zi * zi % P
        out_x[i] = X[i] * zi2 % P
        out_y[i] = Y[i] * zi2 % P * zi % P
    xs = b"".join(v.to_bytes(48, "big") for v in out_x)
    ys = b"".join(v.to_bytes(48, "big") for v in out_y)
    return np.concatenate(
        [np.frombuffer(xs, np.uint8).reshape(n, 48), np.frombuffer(ys, np.uint8).reshape(n, 48)],
        axis=1,
    )


def registry_path(cache_dir: str, n: int, sk0: int) -> str:
    return os.path.join(cache_dir, f"registry_{n}_{sk0:x}.npy")


def registry(n: int, sk0: int, cache_dir: str, pool=None) -> tuple[np.ndarray, bool]:
    """(raw [n, 96] affine pubkeys of sk0 .. sk0+n-1, whether it was built
    now). Walked in REGISTRY_CHUNKS ranges over ``pool``'s workers when
    given; kept in ``cache_dir`` after the first build."""
    path = registry_path(cache_dir, n, sk0)
    if os.path.exists(path):
        return np.load(path), False
    step = -(-n // REGISTRY_CHUNKS)
    jobs = [(sk0 + i, min(step, n - i)) for i in range(0, n, step)]
    parts = pool.map(registry_walk, jobs) if pool is not None else [registry_walk(j) for j in jobs]
    raw = np.concatenate(parts, axis=0)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.partial.npy"
    np.save(tmp, raw)
    os.replace(tmp, path)
    return raw, True


# -- G2 helpers ---------------------------------------------------------------------


_OPS2 = oc.OPS_FQ2


def g2_walk(p0, h, n: int):
    """[p0, p0 + h, ..., p0 + (n-1) h] (affine G2): one Jacobian add per
    point, then one batched normalisation (Montgomery's trick)."""
    hj = oc._to_jac(h, _OPS2)
    jac = [oc._to_jac(p0, _OPS2)]
    for _ in range(n - 1):
        jac.append(oc._jac_add(jac[-1], hj, _OPS2))
    return normalise(jac)


def normalise(jac: list) -> list:
    """Jacobian G2 points (None for infinity) -> affine, one inversion."""
    live = [i for i, p in enumerate(jac) if p is not None]
    out = [None] * len(jac)
    if not live:
        return out
    pref, acc = [], _OPS2.one
    for i in live:
        acc = acc * jac[i][2]
        pref.append(acc)
    inv = acc.inv()
    for j in range(len(live) - 1, -1, -1):
        x, y, z = jac[live[j]]
        zi = inv * pref[j - 1] if j else inv
        inv = inv * z
        zi2 = zi.square()
        out[live[j]] = (x * zi2, y * zi2 * zi)
    return out


class SharedSigner:
    """Signatures over one message ``msg`` by sets of consecutive-key
    validators: ``jac(k, s)`` is (k * sk0 + s) * H(msg) in Jacobian
    coordinates, for 1 <= k <= kmax and 0 <= s < 2^s_bits."""

    def __init__(self, msg: bytes, sk0: int, kmax: int, s_bits: int):
        h = hash_to_curve_g2(bytes(msg), DST)
        base = oc.g2_mul(h, sk0 % R)
        self.tk = [None] + g2_walk(base, base, kmax)
        self.win = []
        for w in range(-(-s_bits // WINDOW_BITS)):
            step = oc.g2_mul(h, 1 << (WINDOW_BITS * w))
            self.win.append([None] + g2_walk(step, step, (1 << WINDOW_BITS) - 1))

    def jac(self, k: int, s: int):
        acc = oc._to_jac(self.tk[k], _OPS2)
        for w, table in enumerate(self.win):
            j = (s >> (WINDOW_BITS * w)) & ((1 << WINDOW_BITS) - 1)
            if j:
                acc = oc._jac_add(acc, oc._to_jac(table[j], _OPS2), _OPS2)
        if s >> (WINDOW_BITS * len(self.win)):
            raise ValueError("scalar wider than the signer's windows")
        return acc


def sign_job(job) -> list:
    """One job of signatures -> their compressed bytes, in order.

    ("shared", msg, sk0, kmax, s_bits, [(k, s), ...]): (k * sk0 + s) * H(msg);
    ("distinct", [(sk, msg), ...]): sk * H(msg)."""
    if job[0] == "shared":
        _, msg, sk0, kmax, s_bits, pairs = job
        signer = SharedSigner(msg, sk0, kmax, s_bits)
        pts = normalise([signer.jac(k, s) for k, s in pairs])
    elif job[0] == "distinct":
        pts = [oc.g2_mul(hash_to_curve_g2(bytes(m), DST), sk % R) for sk, m in job[1]]
    else:
        raise ValueError(f"unknown signing job {job[0]!r}")
    return [oc.g2_compress(p) for p in pts]


def chunked(seq: list, parts: int) -> list:
    """``seq`` cut into at most ``parts`` runs of nearly equal length."""
    step = max(1, -(-len(seq) // max(1, parts)))
    return [seq[i:i + step] for i in range(0, len(seq), step)]
