"""Build and load the native BLS12-381 shared library.

Compiles ``bls12_381.cpp`` with ``g++ -O3 -march=native`` into
``lighthouse_tpu_torch/_build/native/`` at first use and returns a
configured ctypes handle. The library's file name carries a hash of the
source, the compile command and the host CPU's model and flags, so a copy of
the checkout never loads a library built for another source or another CPU.
Several processes may build at once (test workers, the nodes of one host):
each compiles to a file of its own under an exclusive lock, then renames it
into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bls12_381.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
_CMD = ["g++", "-O3", "-march=native", "-fno-exceptions", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib = None


def _host_cpu() -> bytes:
    """The CPU model and flags lines of /proc/cpuinfo (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = {ln for ln in lines if ln.startswith((b"model name", b"flags", b"Features"))}
    return b"\n".join(sorted(keep))


def library_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_CMD).encode() + _host_cpu()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libbls12_381-{key}.so")


def _compile(lib: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):  # another process built it while we waited
            return
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run([*_CMD, _SRC, "-o", tmp], check=True, capture_output=True, text=True)
        os.replace(tmp, lib)


def load_bls() -> ctypes.CDLL:
    """Load (building if needed) and initialize the native BLS library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.bls_native_init.restype = ctypes.c_int
        lib.bls_sk_to_pk.argtypes = [u8p, u8p]
        lib.bls_sign.argtypes = [u8p, u8p, ctypes.c_uint64, u8p]
        lib.bls_hash_to_g2.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.bls_pk_validate.argtypes = [u8p]
        lib.bls_pk_validate.restype = ctypes.c_int
        lib.bls_sig_validate.argtypes = [u8p]
        lib.bls_sig_validate.restype = ctypes.c_int
        lib.bls_verify.argtypes = [u8p, u8p, ctypes.c_uint64, u8p]
        lib.bls_verify.restype = ctypes.c_int
        lib.bls_fast_aggregate_verify.argtypes = [
            ctypes.c_uint64,
            u8p,
            u8p,
            ctypes.c_uint64,
            u8p,
        ]
        lib.bls_fast_aggregate_verify.restype = ctypes.c_int
        lib.bls_aggregate_pubkeys.argtypes = [ctypes.c_uint64, u8p, u8p]
        lib.bls_aggregate_pubkeys.restype = ctypes.c_int
        lib.bls_aggregate_signatures.argtypes = [ctypes.c_uint64, u8p, u8p]
        lib.bls_aggregate_signatures.restype = ctypes.c_int
        lib.bls_verify_signature_sets.argtypes = [
            ctypes.c_uint64,
            u64p,
            u8p,
            u8p,
            u8p,
            u64p,
        ]
        lib.bls_verify_signature_sets.restype = ctypes.c_int
        lib.bls_g2_mul.argtypes = [u8p, u8p, u8p]
        lib.bls_g2_mul.restype = ctypes.c_int
        lib.bls_pk_decompress.argtypes = [u8p, u8p]
        lib.bls_pk_decompress.restype = ctypes.c_int
        lib.bls_verify_signature_sets_raw.argtypes = [
            ctypes.c_uint64,
            u64p,
            u8p,
            u8p,
            u8p,
            u64p,
        ]
        lib.bls_verify_signature_sets_raw.restype = ctypes.c_int
        rc = lib.bls_native_init()
        if rc != 0:
            raise RuntimeError(f"bls_native_init failed: {rc}")
        _lib = lib
        return _lib


def _buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def _check_len(name: str, data: bytes, n: int) -> None:
    if len(data) != n:
        raise ValueError(f"{name} must be {n} bytes, got {len(data)}")


class NativeBls:
    """Bytes-level convenience wrapper over the C API (wire-format in/out)."""

    def __init__(self):
        self._lib = load_bls()

    def sk_to_pk(self, sk: bytes) -> bytes:
        _check_len("sk", sk, 32)
        out = (ctypes.c_uint8 * 48)()
        self._lib.bls_sk_to_pk(_buf(sk), out)
        return bytes(out)

    def sign(self, sk: bytes, msg: bytes) -> bytes:
        _check_len("sk", sk, 32)
        out = (ctypes.c_uint8 * 96)()
        self._lib.bls_sign(_buf(sk), _buf(msg), len(msg), out)
        return bytes(out)

    def hash_to_g2(self, msg: bytes) -> bytes:
        out = (ctypes.c_uint8 * 96)()
        self._lib.bls_hash_to_g2(_buf(msg), len(msg), out)
        return bytes(out)

    def pk_validate(self, pk: bytes) -> bool:
        _check_len("pk", pk, 48)
        return bool(self._lib.bls_pk_validate(_buf(pk)))

    def sig_validate(self, sig: bytes) -> bool:
        _check_len("sig", sig, 96)
        return bool(self._lib.bls_sig_validate(_buf(sig)))

    def verify(self, pk: bytes, msg: bytes, sig: bytes) -> bool:
        _check_len("pk", pk, 48)
        _check_len("sig", sig, 96)
        return bool(self._lib.bls_verify(_buf(pk), _buf(msg), len(msg), _buf(sig)))

    def fast_aggregate_verify(self, pks: list[bytes], msg: bytes, sig: bytes) -> bool:
        if not pks:
            return False
        for pk in pks:
            _check_len("pk", pk, 48)
        _check_len("sig", sig, 96)
        return bool(
            self._lib.bls_fast_aggregate_verify(
                len(pks), _buf(b"".join(pks)), _buf(msg), len(msg), _buf(sig)
            )
        )

    def aggregate_pubkeys(self, pks: list[bytes]) -> bytes:
        out = (ctypes.c_uint8 * 48)()
        rc = self._lib.bls_aggregate_pubkeys(len(pks), _buf(b"".join(pks)), out)
        if rc != 0:
            raise ValueError("invalid pubkey encoding")
        return bytes(out)

    def aggregate_signatures(self, sigs: list[bytes]) -> bytes:
        out = (ctypes.c_uint8 * 96)()
        rc = self._lib.bls_aggregate_signatures(len(sigs), _buf(b"".join(sigs)), out)
        if rc != 0:
            raise ValueError("invalid signature encoding")
        return bytes(out)

    def g2_mul(self, point: bytes, sk: bytes) -> bytes:
        out = (ctypes.c_uint8 * 96)()
        rc = self._lib.bls_g2_mul(_buf(point), _buf(sk), out)
        if rc != 0:
            raise ValueError("invalid point encoding")
        return bytes(out)

    def verify_signature_sets(
        self,
        pk_sets: list[list[bytes]],
        msgs: list[bytes],
        sigs: list[bytes],
        scalars: list[int],
    ) -> bool:
        """RLC batch verification (blst.rs:37-119 semantics): each set is
        (pubkeys, 32-byte message, signature); scalars are nonzero u64."""
        n = len(pk_sets)
        if n == 0:
            return False
        if not (len(msgs) == len(sigs) == len(scalars) == n):
            raise ValueError("set length mismatch")
        for s in pk_sets:
            for pk in s:
                _check_len("pk", pk, 48)
        for m, g in zip(msgs, sigs):
            _check_len("msg", m, 32)
            _check_len("sig", g, 96)
        counts = (ctypes.c_uint64 * n)(*[len(s) for s in pk_sets])
        pks = _buf(b"".join(b"".join(s) for s in pk_sets))
        rc = self._lib.bls_verify_signature_sets(
            n,
            counts,
            pks,
            _buf(b"".join(msgs)),
            _buf(b"".join(sigs)),
            (ctypes.c_uint64 * n)(*scalars),
        )
        if rc < 0:
            raise ValueError("malformed signature set input")
        return bool(rc)

    def pk_decompress(self, pk: bytes) -> bytes:
        """48B compressed -> 96B raw affine (cacheable, skips sqrt later)."""
        out = (ctypes.c_uint8 * 96)()
        if self._lib.bls_pk_decompress(_buf(pk), out) != 0:
            raise ValueError("invalid pubkey encoding")
        return bytes(out)

    def verify_signature_sets_raw(
        self,
        pk_sets: list[list[bytes]],
        msgs: list[bytes],
        sigs: list[bytes],
        scalars: list[int],
    ) -> bool:
        """Batch verification with 96B pre-decompressed (cached) pubkeys."""
        n = len(pk_sets)
        if n == 0:
            return False
        for s in pk_sets:
            for pk in s:
                _check_len("raw pk", pk, 96)
        for m, g in zip(msgs, sigs):
            _check_len("msg", m, 32)
            _check_len("sig", g, 96)
        counts = (ctypes.c_uint64 * n)(*[len(s) for s in pk_sets])
        pks = _buf(b"".join(b"".join(s) for s in pk_sets))
        rc = self._lib.bls_verify_signature_sets_raw(
            n,
            counts,
            pks,
            _buf(b"".join(msgs)),
            _buf(b"".join(sigs)),
            (ctypes.c_uint64 * n)(*scalars),
        )
        if rc < 0:
            raise ValueError("malformed signature set input")
        return bool(rc)
