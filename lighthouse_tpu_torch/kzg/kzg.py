"""KZG polynomial commitments for blobs (Lighthouse crypto/kzg/src/lib.rs:1-281).

The port's copy of ``lighthouse_tpu/kzg/kzg.py``. Lighthouse wraps c-kzg +
rust_eth_kzg; here the scheme is implemented directly on the port's own
BLS12-381 stack — the consensus-spec evaluation-form algorithms (blob in
Lagrange basis on bit-reversed roots of unity, barycentric evaluation,
quotient-polynomial proofs) with commitments and proofs produced by the
backend-pluggable G1 MSM (msm.py: the device ladder over the resident setup,
host Pippenger otherwise) and pairing checks through the oracle pairing.
The batch check runs on the host, as in the JAX package.

Wire formats match Lighthouse: 48-byte compressed commitments/proofs
(kzg_commitment.rs, kzg_proof.rs), 131072-byte blobs, 32-byte field
elements. Fiat-Shamir domains follow the consensus spec
(``FSBLOBVERIFY_V1_`` / ``RCKZGBATCH___V1_``).
"""

from __future__ import annotations

from hashlib import sha256

from ..oracle import curves as oc
from ..oracle.pairing import multi_pairing_is_one
from ..oracle.fields import R as BLS_MODULUS
from . import fr
from .msm import msm, pippenger
from .setup import TrustedSetup, load

BYTES_PER_COMMITMENT = 48
BYTES_PER_PROOF = 48
BYTES_PER_FIELD_ELEMENT = 32
FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_BLOB = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB

FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"

VERSIONED_HASH_VERSION_KZG = 0x01


class KzgError(Exception):
    pass


def kzg_commitment_to_versioned_hash(commitment: bytes) -> bytes:
    """0x01 || sha256(commitment)[1:] (kzg_commitment.rs:8-13)."""
    return bytes([VERSIONED_HASH_VERSION_KZG]) + sha256(commitment).digest()[1:]


class Kzg:
    """Holds the trusted setup; mirrors Lighthouse's ``Kzg`` surface."""

    def __init__(self, setup: TrustedSetup | None = None):
        self.setup = setup or load()
        self.n = self.setup.field_elements_per_blob
        self.bytes_per_blob = self.n * BYTES_PER_FIELD_ELEMENT
        self.roots = fr.compute_roots_of_unity(self.n)
        self._g2_gen = oc.g2_generator()
        self._g2_tau = self.setup.g2_monomial[1]

    # -- parsing -----------------------------------------------------------

    def _blob_to_polynomial(self, blob: bytes) -> list[int]:
        if len(blob) != self.bytes_per_blob:
            raise KzgError(
                f"blob must be {self.bytes_per_blob} bytes, got {len(blob)}"
            )
        try:
            return [
                fr.bytes_to_bls_field(blob[i * 32 : (i + 1) * 32])
                for i in range(self.n)
            ]
        except ValueError as e:
            raise KzgError(str(e)) from None

    @staticmethod
    def _parse_g1(data: bytes, what: str):
        if len(data) != 48:
            raise KzgError(f"{what} must be 48 bytes")
        try:
            pt = oc.g1_decompress(data)
        except ValueError as e:
            raise KzgError(f"bad {what}: {e}") from None
        if pt is not None and not oc.g1_in_subgroup(pt):
            raise KzgError(f"{what} not in subgroup")
        return pt

    # -- commitments -------------------------------------------------------

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        poly = self._blob_to_polynomial(blob)
        return oc.g1_compress(msm(self.setup.g1_lagrange_brp, poly))

    # -- single-point proofs ----------------------------------------------

    def compute_kzg_proof(self, blob: bytes, z_bytes: bytes):
        """(proof, y) proving f(z) = y (spec compute_kzg_proof)."""
        poly = self._blob_to_polynomial(blob)
        z = fr.bytes_to_bls_field(z_bytes)
        proof, y = self._compute_proof_impl(poly, z)
        return proof, fr.bls_field_to_bytes(y)

    def _compute_proof_impl(self, poly: list[int], z: int):
        r = BLS_MODULUS
        roots = self.roots
        y = fr.evaluate_polynomial_in_evaluation_form(poly, z, roots)
        # quotient q(x) = (f(x) - y) / (x - z) in evaluation form
        if z in roots:
            m = roots.index(z)
            q = [0] * len(poly)
            inv_wm = pow(roots[m], r - 2, r)
            # off-diagonal terms + the removable-singularity row m
            denoms = [(w - z) % r if i != m else 1 for i, w in enumerate(roots)]
            inv_d = fr.batch_inverse(denoms)
            for i, (f, w) in enumerate(zip(poly, roots)):
                if i == m:
                    continue
                q[i] = (f - y) % r * inv_d[i] % r
                # q_m += (f_i - y) * w_i / (w_m * (w_m - w_i));
                # 1/(w_m - w_i) = -inv_d[i] since z = w_m
                q[m] = (q[m] + (f - y) * w % r * (-inv_d[i]) % r * inv_wm) % r
        else:
            denoms = [(w - z) % r for w in roots]
            inv_d = fr.batch_inverse(denoms)
            q = [(f - y) % r * inv % r for f, inv in zip(poly, inv_d)]
        proof = msm(self.setup.g1_lagrange_brp, q)
        return oc.g1_compress(proof), y

    def verify_kzg_proof(
        self, commitment: bytes, z_bytes: bytes, y_bytes: bytes, proof: bytes
    ) -> bool:
        """Pairing check e(C - [y]G1, [1]G2) == e(proof, [tau - z]G2)."""
        c = self._parse_g1(commitment, "commitment")
        q = self._parse_g1(proof, "proof")
        z = fr.bytes_to_bls_field(z_bytes)
        y = fr.bytes_to_bls_field(y_bytes)
        return self._verify_impl(c, z, y, q)

    def _verify_impl(self, c, z: int, y: int, q) -> bool:
        g1 = oc.g1_generator()
        p_minus_y = oc.g1_add(c, oc.g1_neg(oc.g1_mul(g1, y)))
        x_minus_z = oc.g2_add(
            self._g2_tau, oc.g2_neg(oc.g2_mul(self._g2_gen, z))
        )
        # e(C - yG, -G2) * e(Q, (tau - z)G2) == 1
        return multi_pairing_is_one(
            [
                (p_minus_y, oc.g2_neg(self._g2_gen)),
                (q, x_minus_z),
            ]
        )

    # -- blob proofs -------------------------------------------------------

    def _compute_challenge(self, blob: bytes, commitment: bytes) -> int:
        data = (
            FIAT_SHAMIR_PROTOCOL_DOMAIN
            + self.n.to_bytes(16, "big")
            + blob
            + commitment
        )
        return fr.hash_to_bls_field(data)

    def compute_blob_kzg_proof(self, blob: bytes, commitment: bytes) -> bytes:
        if len(commitment) != 48:
            raise KzgError("commitment must be 48 bytes")
        poly = self._blob_to_polynomial(blob)
        z = self._compute_challenge(blob, commitment)
        proof, _y = self._compute_proof_impl(poly, z)
        return proof

    def verify_blob_kzg_proof(
        self, blob: bytes, commitment: bytes, proof: bytes
    ) -> bool:
        c = self._parse_g1(commitment, "commitment")
        q = self._parse_g1(proof, "proof")
        poly = self._blob_to_polynomial(blob)
        z = self._compute_challenge(blob, commitment)
        y = fr.evaluate_polynomial_in_evaluation_form(poly, z, self.roots)
        return self._verify_impl(c, z, y, q)

    def verify_blob_kzg_proof_batch(
        self, blobs: list[bytes], commitments: list[bytes], proofs: list[bytes]
    ) -> bool:
        """Random-linear-combination batch: one MSM over proofs/commitments
        and a single 2-pairing check (spec verify_kzg_proof_batch; the
        Lighthouse batch entry point is lib.rs:155-182)."""
        if not (len(blobs) == len(commitments) == len(proofs)):
            raise KzgError("batch length mismatch")
        if not blobs:
            return True
        r_mod = BLS_MODULUS
        cs, qs, zs, ys = [], [], [], []
        for blob, commitment, proof in zip(blobs, commitments, proofs):
            cs.append(self._parse_g1(commitment, "commitment"))
            qs.append(self._parse_g1(proof, "proof"))
            poly = self._blob_to_polynomial(blob)
            z = self._compute_challenge(blob, commitment)
            zs.append(z)
            ys.append(
                fr.evaluate_polynomial_in_evaluation_form(poly, z, self.roots)
            )
        data = (
            RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
            + self.n.to_bytes(8, "big")
            + len(blobs).to_bytes(8, "big")
        )
        for commitment, z, y, proof in zip(commitments, zs, ys, proofs):
            data += commitment + fr.bls_field_to_bytes(z) + fr.bls_field_to_bytes(y) + proof
        r = fr.hash_to_bls_field(data)
        powers, acc = [], 1
        for _ in range(len(blobs)):
            powers.append(acc)
            acc = acc * r % r_mod
        # C' = sum r^i (C_i - [y_i]G1 + z_i Q_i);  Q' = sum r^i Q_i
        # check e(C', -G2) * e(Q', tau G2) == 1
        g1 = oc.g1_generator()
        terms, scalars = [], []
        for c, q, z, y, p in zip(cs, qs, zs, ys, powers):
            terms.extend([c, g1, q])
            scalars.extend([p, (-p * y) % r_mod, p * z % r_mod])
        c_prime = pippenger(terms, scalars)
        q_prime = pippenger(qs, powers)
        return multi_pairing_is_one(
            [
                (c_prime, oc.g2_neg(self._g2_gen)),
                (q_prime, self._g2_tau),
            ]
        )
