"""KZG cells: erasure-extended blobs for data-availability sampling.

The port's copy of ``lighthouse_tpu/kzg/cells.py``: Lighthouse's PeerDAS
cell API (``crypto/kzg/src/lib.rs:220-274``: ``compute_cells_and_proofs`` /
``verify_cell_proof_batch`` / ``recover_cells_and_kzg_proofs``; spec:
EIP-7594 polynomial-commitments-sampling). The blob polynomial (degree < n,
given in bit-reversed evaluation form) is Reed-Solomon extended onto the
2n-th roots of unity; the bit-reversed extended domain chunks into
``CELLS_PER_EXT_BLOB`` cosets of the (2n/cells)-subgroup ("cells"). Each
cell carries one KZG multi-opening proof:

    q(X) = (p(X) - I(X)) / Z_H(X),  Z_H(X) = X^k - h^k

with I the interpolant of p on coset H and the proof a monomial-basis
commitment to q. Verification is the pairing check
``e(C - [I(tau)], G2) == e(proof, [Z_H(tau)]_2)``, needing G2 powers of tau
up to k. Recovery from >= 50% of cells runs the vanishing-polynomial method
over the extended domain (cosets are the erasure granularity, so Z_missing
is a product of sparse ``X^k - d`` factors).

The per-cell verify loop here is host Python (the oracle pairing); the
batched device check is ``engine.py``. Cell geometry derives from the
trusted-setup size so the full cycle runs at test scale (mainnet: n = 4096,
cells = 128, k = 64).
"""

from __future__ import annotations

import functools

from ..oracle import curves as oc
from ..oracle.fields import R
from . import fr
from .fr import bit_reversal_permutation as brp
from .kzg import Kzg, KzgError
from .msm import msm

CELLS_PER_EXT_BLOB = 128  # spec constant (mainnet geometry)
BYTES_PER_FIELD_ELEMENT = 32
RECOVERY_SHIFT = 7  # coset shift for the division-by-Z step


def _fft(vals: list[int], root: int, invert: bool = False) -> list[int]:
    """Iterative radix-2 NTT over Fr, natural order in and out."""
    n = len(vals)
    if n == 1:
        return list(vals)
    if invert:
        root = pow(root, R - 2, R)
    a = list(vals)
    # bit-reversal reorder
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(root, n // length, R)
        for i in range(0, n, length):
            w = 1
            half = length // 2
            for k in range(i, i + half):
                u, v = a[k], a[k + half] * w % R
                a[k] = (u + v) % R
                a[k + half] = (u - v) % R
                w = w * w_len % R
        length *= 2
    if invert:
        inv_n = pow(n, R - 2, R)
        a = [x * inv_n % R for x in a]
    return a


class CellContext:
    """Cell geometry + domains for one trusted setup."""

    def __init__(self, kzg: Kzg, cells_per_ext_blob: int = CELLS_PER_EXT_BLOB,
                 msm_backend: str | None = None):
        self.kzg = kzg
        # every MSM below routes through the one kzg/msm.py dispatch seam;
        # None defers to bls.get_backend(); the device arm runs on
        # bls.get_device()
        self.msm_backend = msm_backend
        self.n = kzg.n
        self.ext = 2 * self.n
        self.cells = min(cells_per_ext_blob, self.ext)
        self.k = self.ext // self.cells  # field elements per cell
        self.bytes_per_cell = self.k * BYTES_PER_FIELD_ELEMENT
        if len(kzg.setup.g2_monomial) <= self.k:
            raise KzgError(
                f"trusted setup has {len(kzg.setup.g2_monomial)} G2 powers; "
                f"cell proofs need tau^{self.k}"
            )
        # natural-order ext roots + their brp view (chunking order)
        self.w_n = pow(
            fr.PRIMITIVE_ROOT_OF_UNITY, (R - 1) // self.n, R
        )
        self.w_ext = pow(
            fr.PRIMITIVE_ROOT_OF_UNITY, (R - 1) // self.ext, R
        )
        self.ext_roots_nat = [pow(self.w_ext, i, R) for i in range(self.ext)]
        self.ext_roots_brp = brp(self.ext_roots_nat)
        self.mu = pow(self.w_ext, self.cells, R)  # k-th root for cosets
        self._mu_pows = [pow(self.mu, j, R) for j in range(self.k)]
        self.g2_gen = oc.g2_generator()

    # -- coset helpers -----------------------------------------------------

    def coset_points(self, cell_index: int) -> list[int]:
        """The chunk of brp extended roots backing cell ``cell_index``."""
        return self.ext_roots_brp[
            cell_index * self.k : (cell_index + 1) * self.k
        ]

    def _coset_base(self, pts: list[int]) -> int:
        """The coset is {c * mu^j}; return c (the chunk's j=0 element)."""
        c = pts[0]
        members = {c * m % R for m in self._mu_pows}
        if set(pts) != members:
            raise KzgError("cell chunk is not a mu-coset")  # geometry bug
        return c

    def _interpolant_coeffs(self, pts: list[int], vals: list[int]) -> list[int]:
        """Coefficients of I with I(pts[j]) = vals[j] (|pts| = k)."""
        c = self._coset_base(pts)
        # natural coset order c*mu^j: map chunk order -> j by lookup
        inv_c = pow(c, R - 2, R)
        order = {m: j for j, m in enumerate(self._mu_pows)}
        nat = [0] * self.k
        for p, v in zip(pts, vals):
            nat[order[p * inv_c % R]] = v
        b = _fft(nat, self.mu, invert=True)
        inv_ci = fr.batch_inverse([pow(c, j, R) for j in range(self.k)])
        return [b[j] * inv_ci[j] % R for j in range(self.k)]

    # -- compute -----------------------------------------------------------

    def blob_to_coeffs(self, blob: bytes) -> list[int]:
        evals_brp = self.kzg._blob_to_polynomial(blob)
        return _fft(brp(evals_brp), self.w_n, invert=True)

    def cells_from_coeffs(self, coeffs: list[int]) -> list[list[int]]:
        ext_evals = _fft(coeffs + [0] * (self.ext - len(coeffs)), self.w_ext)
        ext_brp = brp(ext_evals)
        return [
            ext_brp[i * self.k : (i + 1) * self.k]
            for i in range(self.cells)
        ]

    def _cell_proof(self, coeffs: list[int], cell_index: int,
                    cell_vals: list[int]) -> bytes:
        pts = self.coset_points(cell_index)
        interp = self._interpolant_coeffs(pts, cell_vals)
        d = pow(self._coset_base(pts), self.k, R)
        # (p - I) / (X^k - d) by synthetic division; remainder must vanish
        rem = list(coeffs)
        for j, a in enumerate(interp):
            rem[j] = (rem[j] - a) % R
        q = [0] * (len(rem) - self.k)
        for i in range(len(rem) - 1, self.k - 1, -1):
            q[i - self.k] = rem[i]
            rem[i - self.k] = (rem[i - self.k] + d * rem[i]) % R
            rem[i] = 0
        if any(rem[: self.k]):
            raise KzgError("cell does not lie on the blob polynomial")
        proof = msm(
            self.kzg.setup.g1_monomial[: len(q)], q,
            backend=self.msm_backend,
        )
        return oc.g1_compress(proof)

    def compute_cells_and_kzg_proofs(
        self, blob: bytes
    ) -> tuple[list[bytes], list[bytes]]:
        return self._emit(self.blob_to_coeffs(blob))

    # -- verify ------------------------------------------------------------

    def _cell_to_fields(self, cell: bytes) -> list[int]:
        """A cell's field elements; KzgError on a wrong length or a
        non-canonical element (malformed input is a False verdict, never a
        device fault: the reference lets the element's ValueError escape)."""
        if len(cell) != self.bytes_per_cell:
            raise KzgError(f"cell must be {self.bytes_per_cell} bytes")
        try:
            return [
                fr.bytes_to_bls_field(cell[i * 32 : (i + 1) * 32])
                for i in range(self.k)
            ]
        except ValueError as e:
            raise KzgError(str(e)) from None

    @functools.lru_cache(maxsize=256)
    def _coset_verify_consts(self, cell_index: int):
        """(pts, [Z(tau)]_2) per coset — identical for every repeated index
        in a batch (each data column repeats one index per blob)."""
        pts = tuple(self.coset_points(cell_index))
        d = pow(self._coset_base(list(pts)), self.k, R)
        z2 = oc.g2_add(
            self.kzg.setup.g2_monomial[self.k],
            oc.g2_neg(oc.g2_mul(self.g2_gen, d)),
        )
        return pts, z2

    def verify_cell_kzg_proof(
        self, commitment: bytes, cell_index: int, cell: bytes, proof: bytes
    ) -> bool:
        if not 0 <= cell_index < self.cells:
            return False
        try:
            vals = self._cell_to_fields(cell)
            c_pt = self.kzg._parse_g1(commitment, "commitment")
            q_pt = self.kzg._parse_g1(proof, "proof")
        except KzgError:
            return False
        pts_t, z2 = self._coset_verify_consts(cell_index)
        pts = list(pts_t)
        interp = self._interpolant_coeffs(pts, vals)
        i_commit = msm(
            self.kzg.setup.g1_monomial[: self.k], interp,
            backend=self.msm_backend,
        )
        from ..oracle.pairing import multi_pairing_is_one

        lhs = oc.g1_add(c_pt, oc.g1_neg(i_commit)) if c_pt else (
            oc.g1_neg(i_commit) if i_commit else None
        )
        # e(C - [I], G2) * e(-proof, [Z(tau)]_2) == 1
        pairs = []
        if lhs is not None:
            pairs.append((lhs, self.g2_gen))
        if q_pt is not None:
            pairs.append((oc.g1_neg(q_pt), z2))
        if not pairs:
            return True  # C == [I] and proof at infinity: identity holds
        return multi_pairing_is_one(pairs)

    def verify_cell_kzg_proof_batch(
        self, commitments: list[bytes], cell_indices: list[int],
        cells: list[bytes], proofs: list[bytes],
    ) -> bool:
        if not (
            len(commitments) == len(cell_indices) == len(cells) == len(proofs)
        ):
            return False
        return all(
            self.verify_cell_kzg_proof(c, i, cell, pr)
            for c, i, cell, pr in zip(commitments, cell_indices, cells, proofs)
        )

    # -- recover -----------------------------------------------------------

    def recover_cells_and_kzg_proofs(
        self, cell_indices: list[int], cells: list[bytes]
    ) -> tuple[list[bytes], list[bytes]]:
        """Rebuild ALL cells + proofs from >= 50% of them (spec
        recover_cells_and_kzg_proofs; ref ``crypto/kzg/src/lib.rs:274``)."""
        have = dict(zip(cell_indices, cells))
        if len(have) != len(cell_indices):
            raise KzgError("duplicate cell indices")
        if len(have) * 2 < self.cells:
            raise KzgError("recovery needs at least half the cells")
        if any(not 0 <= i < self.cells for i in have):
            raise KzgError("cell index out of range")
        missing = [i for i in range(self.cells) if i not in have]
        if not missing:
            # nothing to recover; still recompute proofs from the data
            ext_brp = []
            for i in range(self.cells):
                ext_brp.extend(self._cell_to_fields(have[i]))
            coeffs = self._coeffs_from_full_ext(ext_brp)
            return self._emit(coeffs)

        # E: known evals, zero at missing positions (natural ext order)
        ext_brp_vals = [0] * self.ext
        for i, cell in have.items():
            vals = self._cell_to_fields(cell)
            ext_brp_vals[i * self.k : (i + 1) * self.k] = vals
        e_nat = self._unbrp(ext_brp_vals)

        # Z_missing(X) = prod over missing cosets (X^k - d_i): sparse factors
        z_coeffs = [1]
        for i in missing:
            d = pow(self._coset_base(self.coset_points(i)), self.k, R)
            nxt = [0] * (len(z_coeffs) + self.k)
            for j, a in enumerate(z_coeffs):
                nxt[j + self.k] = (nxt[j + self.k] + a) % R
                nxt[j] = (nxt[j] - d * a) % R
            z_coeffs = nxt
        z_nat = _fft(z_coeffs + [0] * (self.ext - len(z_coeffs)), self.w_ext)

        # (p*Z) agrees with (E*Z) on the whole extended domain
        pz_coeffs = _fft(
            [e * z % R for e, z in zip(e_nat, z_nat)], self.w_ext, invert=True
        )
        # divide by Z on a shifted coset where Z never vanishes
        s = RECOVERY_SHIFT
        s_pows = [pow(s, i, R) for i in range(self.ext)]
        pz_shift = _fft(
            [c * sp % R for c, sp in zip(pz_coeffs, s_pows)], self.w_ext
        )
        z_shift = _fft(
            [
                c * sp % R
                for c, sp in zip(
                    z_coeffs + [0] * (self.ext - len(z_coeffs)), s_pows
                )
            ],
            self.w_ext,
        )
        p_shift = [
            a * b % R
            for a, b in zip(pz_shift, fr.batch_inverse(z_shift))
        ]
        p_scaled = _fft(p_shift, self.w_ext, invert=True)
        inv_s = fr.batch_inverse(s_pows)
        coeffs = [c * i % R for c, i in zip(p_scaled, inv_s)]
        if any(coeffs[self.n :]):
            raise KzgError("recovered data is not a degree < n polynomial")
        coeffs = coeffs[: self.n]
        out_cells, out_proofs = self._emit(coeffs)
        # sanity: recovery must reproduce the supplied cells
        for i, cell in have.items():
            if out_cells[i] != cell:
                raise KzgError("recovered cells disagree with inputs")
        return out_cells, out_proofs

    def _unbrp(self, vals_brp: list[int]) -> list[int]:
        idx = brp(list(range(self.ext)))
        out = [0] * self.ext
        for pos, v in zip(idx, vals_brp):
            out[pos] = v
        return out

    def _coeffs_from_full_ext(self, ext_brp_vals: list[int]) -> list[int]:
        nat = self._unbrp(ext_brp_vals)
        coeffs = _fft(nat, self.w_ext, invert=True)
        if any(coeffs[self.n :]):
            raise KzgError("data is not a degree < n polynomial")
        return coeffs[: self.n]

    def _emit(self, coeffs: list[int]) -> tuple[list[bytes], list[bytes]]:
        cell_vals = self.cells_from_coeffs(coeffs)
        cells = [
            b"".join(fr.bls_field_to_bytes(v) for v in vals)
            for vals in cell_vals
        ]
        proofs = [
            self._cell_proof(coeffs, i, vals)
            for i, vals in enumerate(cell_vals)
        ]
        return cells, proofs


@functools.lru_cache(maxsize=4)
def cell_context(kzg: Kzg = None, cells_per_ext_blob: int = CELLS_PER_EXT_BLOB):
    return CellContext(kzg or Kzg(), cells_per_ext_blob)
