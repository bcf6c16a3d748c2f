"""SSZ type system: basic/composite types, strict (de)serialization, tree roots.

Design: SSZ *types* are descriptor objects (instances of the classes below);
SSZ *values* are plain Python data — ints, bools, bytes, lists, numpy arrays
(fast path for uint lists/vectors), and ``Container`` subclasses. This mirrors
the reference's split between the ``Encode``/``Decode``/``TreeHash`` traits
and the container structs (``consensus/types``), without Rust's monomorphized
generics: a network preset is a set of descriptor instances.

Deserialization is strict: offset monotonicity, exact-length consumption, and
canonical bitlist delimiters are enforced (ssz_static EF-test discipline).
"""

from __future__ import annotations

import operator

import numpy as np

from .merkle import merkleize_chunks, mix_in_length, mix_in_selector, next_pow2
from .sha256 import sha256_pairs

OFFSET_LEN = 4


class SSZError(Exception):
    pass


def _pack_bytes(data: bytes) -> np.ndarray:
    """bytes -> [ceil(n/32), 32] chunk rows (zero padded)."""
    n = (len(data) + 31) // 32
    buf = np.zeros((max(n, 1), 32), dtype=np.uint8)
    if data:
        flat = np.frombuffer(data, dtype=np.uint8)
        buf.reshape(-1)[: len(flat)] = flat
    if n == 0:
        return buf[:0]
    return buf[:n] if n else buf


class SSZType:
    is_fixed: bool = True

    def fixed_len(self) -> int:
        raise NotImplementedError

    def encode(self, value) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError


class UInt(SSZType):
    def __init__(self, byte_len: int):
        self.byte_len = byte_len

    def fixed_len(self):
        return self.byte_len

    def encode(self, value) -> bytes:
        return int(value).to_bytes(self.byte_len, "little")

    def decode(self, data: bytes):
        if len(data) != self.byte_len:
            raise SSZError(f"uint{self.byte_len * 8}: bad length {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value) -> bytes:
        return self.encode(value).ljust(32, b"\x00")

    def default(self):
        return 0

    def __repr__(self):
        return f"uint{self.byte_len * 8}"


class Boolean(SSZType):
    def fixed_len(self):
        return 1

    def encode(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def decode(self, data: bytes):
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise SSZError("boolean: invalid byte")

    def hash_tree_root(self, value) -> bytes:
        return self.encode(value).ljust(32, b"\x00")

    def default(self):
        return False

    def __repr__(self):
        return "boolean"


uint8 = UInt(1)
uint16 = UInt(2)
uint32 = UInt(4)
uint64 = UInt(8)
uint128 = UInt(16)
uint256 = UInt(32)
boolean = Boolean()

_NP_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


class ByteVector(SSZType):
    def __init__(self, length: int):
        self.length = length

    def fixed_len(self):
        return self.length

    def encode(self, value) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise SSZError(f"ByteVector[{self.length}]: got {len(value)}")
        return value

    def decode(self, data: bytes):
        if len(data) != self.length:
            raise SSZError(f"ByteVector[{self.length}]: bad length {len(data)}")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        return merkleize_chunks(_pack_bytes(self.encode(value)))

    def default(self):
        return b"\x00" * self.length

    def __repr__(self):
        return f"ByteVector[{self.length}]"


class ByteList(SSZType):
    is_fixed = False

    def __init__(self, limit: int):
        self.limit = limit

    def encode(self, value) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise SSZError(f"ByteList[{self.limit}]: got {len(value)}")
        return value

    def decode(self, data: bytes):
        if len(data) > self.limit:
            raise SSZError(f"ByteList[{self.limit}]: bad length {len(data)}")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        value = self.encode(value)
        root = merkleize_chunks(
            _pack_bytes(value), limit=(self.limit + 31) // 32
        )
        return mix_in_length(root, len(value))

    def default(self):
        return b""

    def __repr__(self):
        return f"ByteList[{self.limit}]"


class _Sequence(SSZType):
    """Shared machinery for Vector/List of arbitrary element type, with a
    numpy fast path when the element is a UInt."""

    def __init__(self, elem: SSZType):
        self.elem = elem

    def _encode_elems(self, values) -> bytes:
        e = self.elem
        if isinstance(e, UInt):
            arr = np.asarray(values, dtype=_NP_DTYPE.get(e.byte_len, object))
            if arr.dtype != object:
                return arr.astype(arr.dtype.newbyteorder("<")).tobytes()
            return b"".join(e.encode(v) for v in values)
        if isinstance(e, type) and issubclass(e, Container) and e._flat_fields:
            raw = _flat_container_encode(e, values)
            if raw is not None:
                return raw
        if e.is_fixed:
            return b"".join(e.encode(v) for v in values)
        parts = [e.encode(v) for v in values]
        head = len(parts) * OFFSET_LEN
        out = bytearray()
        for p in parts:
            out += head.to_bytes(OFFSET_LEN, "little")
            head += len(p)
        for p in parts:
            out += p
        return bytes(out)

    def _decode_elems(self, data: bytes, count_hint=None):
        e = self.elem
        if e.is_fixed:
            k = e.fixed_len()
            if len(data) % k:
                raise SSZError("sequence: length not multiple of element size")
            n = len(data) // k
            if isinstance(e, UInt) and e.byte_len in _NP_DTYPE:
                dt = np.dtype(_NP_DTYPE[e.byte_len]).newbyteorder("<")
                return list(
                    np.frombuffer(data, dtype=dt).astype(_NP_DTYPE[e.byte_len])
                )
            return [e.decode(data[i * k : (i + 1) * k]) for i in range(n)]
        if not data:
            return []
        first = int.from_bytes(data[:OFFSET_LEN], "little")
        if first % OFFSET_LEN or first == 0:
            raise SSZError("sequence: bad first offset")
        n = first // OFFSET_LEN
        offs = [
            int.from_bytes(data[i * OFFSET_LEN : (i + 1) * OFFSET_LEN], "little")
            for i in range(n)
        ]
        offs.append(len(data))
        if offs[0] != n * OFFSET_LEN:
            raise SSZError("sequence: first offset mismatch")
        out = []
        for i in range(n):
            if offs[i + 1] < offs[i]:
                raise SSZError("sequence: non-monotonic offsets")
            out.append(e.decode(data[offs[i] : offs[i + 1]]))
        return out

    def _elem_chunks(self, values) -> np.ndarray:
        e = self.elem
        if isinstance(e, (UInt, Boolean)):
            return _pack_bytes(self._encode_elems(values))
        if isinstance(e, ByteVector) and e.length <= 32:  # one chunk each
            raw = b"".join(e.encode(v).ljust(32, b"\x00") for v in values)
            return np.frombuffer(raw, np.uint8).reshape(-1, 32)
        if isinstance(e, type) and issubclass(e, Container) and e._leaf_fields:
            return _flat_container_roots(e, values)
        roots = [e.hash_tree_root(v) for v in values]
        if not roots:
            return np.zeros((0, 32), dtype=np.uint8)
        return np.stack([np.frombuffer(r, dtype=np.uint8) for r in roots])

    def _chunk_limit(self, length: int) -> int:
        e = self.elem
        if isinstance(e, (UInt, Boolean)):
            return (length * e.fixed_len() + 31) // 32
        return length


class Vector(_Sequence):
    def __init__(self, elem: SSZType, length: int):
        super().__init__(elem)
        if length == 0:
            raise SSZError("Vector length must be > 0")
        self.length = length
        self.is_fixed = elem.is_fixed

    def fixed_len(self):
        return self.length * self.elem.fixed_len()

    def encode(self, value) -> bytes:
        if len(value) != self.length:
            raise SSZError(f"Vector[{self.length}]: got {len(value)}")
        return self._encode_elems(value)

    def decode(self, data: bytes):
        vals = self._decode_elems(data)
        if len(vals) != self.length:
            raise SSZError(f"Vector[{self.length}]: decoded {len(vals)}")
        return vals

    def hash_tree_root(self, value) -> bytes:
        if len(value) != self.length:
            raise SSZError(f"Vector[{self.length}]: got {len(value)}")
        return self.root_from_chunks(self._elem_chunks(value), len(value))

    def root_from_chunks(self, chunks, n: int) -> bytes:
        return merkleize_chunks(chunks, limit=self._chunk_limit(self.length))

    def default(self):
        return [self.elem.default() for _ in range(self.length)]

    def __repr__(self):
        return f"Vector[{self.elem!r}, {self.length}]"


class List(_Sequence):
    is_fixed = False

    def __init__(self, elem: SSZType, limit: int):
        super().__init__(elem)
        self.limit = limit

    def encode(self, value) -> bytes:
        if len(value) > self.limit:
            raise SSZError(f"List[{self.limit}]: got {len(value)}")
        return self._encode_elems(value)

    def decode(self, data: bytes):
        vals = self._decode_elems(data)
        if len(vals) > self.limit:
            raise SSZError(f"List[{self.limit}]: decoded {len(vals)}")
        return vals

    def hash_tree_root(self, value) -> bytes:
        if len(value) > self.limit:
            raise SSZError(f"List[{self.limit}]: got {len(value)}")
        return self.root_from_chunks(self._elem_chunks(value), len(value))

    def root_from_chunks(self, chunks, n: int) -> bytes:
        root = merkleize_chunks(chunks, limit=self._chunk_limit(self.limit))
        return mix_in_length(root, n)

    def default(self):
        return []

    def __repr__(self):
        return f"List[{self.elem!r}, {self.limit}]"


class Bitvector(SSZType):
    def __init__(self, length: int):
        if length == 0:
            raise SSZError("Bitvector length must be > 0")
        self.length = length

    def fixed_len(self):
        return (self.length + 7) // 8

    def encode(self, value) -> bytes:
        bits = np.asarray(value, dtype=bool)
        if bits.shape != (self.length,):
            raise SSZError(f"Bitvector[{self.length}]: got {bits.shape}")
        return np.packbits(bits, bitorder="little").tobytes()

    def decode(self, data: bytes):
        if len(data) != self.fixed_len():
            raise SSZError(f"Bitvector[{self.length}]: bad length")
        bits = np.unpackbits(
            np.frombuffer(data, dtype=np.uint8), bitorder="little"
        )
        if bits[self.length :].any():
            raise SSZError("Bitvector: nonzero padding bits")
        return bits[: self.length].astype(bool)

    def hash_tree_root(self, value) -> bytes:
        return merkleize_chunks(
            _pack_bytes(self.encode(value)), limit=(self.length + 255) // 256
        )

    def default(self):
        return np.zeros(self.length, dtype=bool)

    def __repr__(self):
        return f"Bitvector[{self.length}]"


class Bitlist(SSZType):
    is_fixed = False

    def __init__(self, limit: int):
        self.limit = limit

    def encode(self, value) -> bytes:
        bits = np.asarray(value, dtype=bool)
        if bits.size > self.limit:
            raise SSZError(f"Bitlist[{self.limit}]: got {bits.size}")
        with_delim = np.concatenate([bits, [True]])
        return np.packbits(with_delim, bitorder="little").tobytes()

    def decode(self, data: bytes):
        if not data:
            raise SSZError("Bitlist: empty")
        if data[-1] == 0:
            raise SSZError("Bitlist: missing delimiter")
        bits = np.unpackbits(
            np.frombuffer(data, dtype=np.uint8), bitorder="little"
        )
        # position of the delimiter = highest set bit
        top = int(np.max(np.nonzero(bits)[0]))
        n = top
        if n > self.limit:
            raise SSZError(f"Bitlist[{self.limit}]: decoded {n}")
        if len(data) != (n + 1 + 7) // 8:
            raise SSZError("Bitlist: non-canonical length")
        return bits[:n].astype(bool)

    def hash_tree_root(self, value) -> bytes:
        bits = np.asarray(value, dtype=bool)
        if bits.size > self.limit:
            raise SSZError(f"Bitlist[{self.limit}]: got {bits.size}")
        data = np.packbits(bits, bitorder="little").tobytes()
        root = merkleize_chunks(
            _pack_bytes(data) if bits.size else np.zeros((0, 32), np.uint8),
            limit=(self.limit + 255) // 256,
        )
        return mix_in_length(root, int(bits.size))

    def default(self):
        return np.zeros(0, dtype=bool)

    def __repr__(self):
        return f"Bitlist[{self.limit}]"


class Union(SSZType):
    is_fixed = False

    def __init__(self, options: list):
        self.options = options  # list of SSZType | None (None only at index 0)

    def encode(self, value) -> bytes:
        sel, v = value
        t = self.options[sel]
        if t is None:
            if v is not None:
                raise SSZError("Union: None option carries no value")
            return b"\x00"
        return bytes([sel]) + t.encode(v)

    def decode(self, data: bytes):
        if not data:
            raise SSZError("Union: empty")
        sel = data[0]
        if sel >= len(self.options):
            raise SSZError("Union: bad selector")
        t = self.options[sel]
        if t is None:
            if len(data) != 1:
                raise SSZError("Union: trailing bytes after None")
            return (0, None)
        return (sel, t.decode(data[1:]))

    def hash_tree_root(self, value) -> bytes:
        sel, v = value
        t = self.options[sel]
        root = b"\x00" * 32 if t is None else t.hash_tree_root(v)
        return mix_in_selector(root, sel)

    def default(self):
        t = self.options[0]
        return (0, None if t is None else t.default())


class Container(SSZType):
    """Subclass with a class attribute ``FIELDS: list[(name, SSZType)]``.
    The class doubles as the type descriptor and the value constructor."""

    FIELDS: list = []

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._names = [n for n, _ in cls.FIELDS]
        cls._types = dict(cls.FIELDS)
        cls.is_fixed = all(t.is_fixed for _, t in cls.FIELDS)
        # every field a numpy-width uint, a boolean or a byte vector: lists of
        # these encode column by column (_flat_container_encode)
        cls._flat_fields = bool(cls.FIELDS) and all(
            (isinstance(t, UInt) and t.byte_len in _NP_DTYPE)
            or isinstance(t, (Boolean, ByteVector))
            for _, t in cls.FIELDS
        )
        # every field one 32-byte leaf (uint, boolean) or a byte vector of at
        # most two chunks: lists of these hash in batches (_flat_container_roots)
        cls._leaf_fields = bool(cls.FIELDS) and all(
            isinstance(t, (UInt, Boolean))
            or (isinstance(t, ByteVector) and t.length <= 64)
            for _, t in cls.FIELDS
        )
        if cls._leaf_fields:
            # a field set drops the element's root memo (_flat_container_roots)
            cls.__setattr__ = _leaf_setattr

    def __init__(self, **kwargs):
        for name, typ in self.FIELDS:
            if name in kwargs:
                setattr(self, name, kwargs.pop(name))
            else:
                setattr(self, name, typ.default())
        if kwargs:
            raise SSZError(f"{type(self).__name__}: unknown fields {list(kwargs)}")

    def __eq__(self, other):
        return type(self) is type(other) and all(
            _val_eq(getattr(self, n), getattr(other, n)) for n in self._names
        )

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._names[:4])
        more = "..." if len(self._names) > 4 else ""
        return f"{type(self).__name__}({inner}{more})"

    def copy(self):
        """Mutation-safe copy: nested containers are copied recursively
        (lists of containers copy each element), so in-place mutation of a
        copy never leaks into the original — required by the chain layer,
        which caches parent states and replays children off copies."""
        new = type(self).__new__(type(self))
        d = new.__dict__
        for n in self._names:
            v = getattr(self, n)
            if isinstance(v, Container):
                v = v.copy()
            elif isinstance(v, list):
                v = [x.copy() if isinstance(x, Container) else x for x in v]
            elif isinstance(v, np.ndarray):
                v = v.copy()
            d[n] = v
        memo = self.__dict__.get("_root_memo")
        if memo is not None:  # the same field values: the same root
            d["_root_memo"] = memo
        fields = self.__dict__.get("_field_roots")
        if fields is not None:  # each entry holds a private copy of its value
            d["_field_roots"] = dict(fields)
        return new

    # -- descriptor protocol (classmethods so the class IS the type) --

    @classmethod
    def fixed_len(cls) -> int:
        return sum(
            t.fixed_len() if t.is_fixed else OFFSET_LEN for _, t in cls.FIELDS
        )

    @classmethod
    def encode(cls, value=None) -> bytes:
        v = value
        fixed_parts, var_parts = [], []
        for name, t in cls.FIELDS:
            fv = getattr(v, name)
            if t.is_fixed:
                fixed_parts.append(t.encode(fv))
                var_parts.append(b"")
            else:
                fixed_parts.append(None)
                var_parts.append(t.encode(fv))
        head = sum(
            len(p) if p is not None else OFFSET_LEN for p in fixed_parts
        )
        out = bytearray()
        off = head
        for p, vp in zip(fixed_parts, var_parts):
            if p is not None:
                out += p
            else:
                out += off.to_bytes(OFFSET_LEN, "little")
                off += len(vp)
        for vp in var_parts:
            out += vp
        return bytes(out)

    def serialize(self) -> bytes:
        return type(self).encode(self)

    @classmethod
    def decode(cls, data: bytes):
        fixed_len = cls.fixed_len()
        if len(data) < fixed_len:
            raise SSZError(f"{cls.__name__}: truncated")
        pos = 0
        offsets, fixed_vals = [], {}
        var_fields = []
        for name, t in cls.FIELDS:
            if t.is_fixed:
                k = t.fixed_len()
                fixed_vals[name] = t.decode(data[pos : pos + k])
                pos += k
            else:
                off = int.from_bytes(data[pos : pos + OFFSET_LEN], "little")
                offsets.append(off)
                var_fields.append((name, t))
                pos += OFFSET_LEN
        if var_fields:
            if offsets[0] != fixed_len:
                raise SSZError(f"{cls.__name__}: first offset mismatch")
            offsets.append(len(data))
            for i, (name, t) in enumerate(var_fields):
                if offsets[i + 1] < offsets[i]:
                    raise SSZError(f"{cls.__name__}: non-monotonic offsets")
                fixed_vals[name] = t.decode(data[offsets[i] : offsets[i + 1]])
        elif len(data) != fixed_len:
            raise SSZError(f"{cls.__name__}: trailing bytes")
        obj = cls.__new__(cls)
        obj.__dict__.update(fixed_vals)  # a new object: no memo to drop
        return obj

    @classmethod
    def hash_tree_root(cls, value=None) -> bytes:
        v = value if value is not None else cls
        memo = v.__dict__.setdefault("_field_roots", {}) if value is not None else None
        roots = np.stack(
            [
                np.frombuffer(_field_root(memo, n, t, getattr(v, n)), dtype=np.uint8)
                for n, t in cls.FIELDS
            ]
        )
        return merkleize_chunks(roots)

    def tree_root(self) -> bytes:
        return type(self).hash_tree_root(self)

    @classmethod
    def default(cls):
        return cls()


_FIELD_MEMO_MIN = 4096  # elements: smaller fields hash faster than they compare


def _field_snapshot(x):
    """A private copy of a large field value whose equality with a later
    value proves the root unchanged, or None when the field is small or may
    hold mutable elements (lists of containers keep per-element memos)."""
    if isinstance(x, np.ndarray):
        return x.copy() if x.size >= _FIELD_MEMO_MIN else None
    if isinstance(x, list) and len(x) >= _FIELD_MEMO_MIN:
        if all(type(e) is bytes or type(e) is int for e in x):
            return list(x)
    return None


def _field_root(memo, name: str, t, x) -> bytes:
    """``t.hash_tree_root(x)``, kept per container instance for large fields
    against a private copy of what decides the root: for basic fields
    (balances, participation, inactivity scores, randao mixes, the root
    vectors) a copy of the value, for lists of leaf containers (the
    registry) the elements' roots (each element's own memo makes them
    cheap). An equal copy reuses the root, anything else hashes again.
    Empty slots change none of a mainnet state's large fields but the two
    root vectors."""
    if memo is None:
        return t.hash_tree_root(x)
    if (isinstance(x, list) and len(x) >= _FIELD_MEMO_MIN and isinstance(t, _Sequence)
            and isinstance(t.elem, type) and issubclass(t.elem, Container)
            and t.elem._leaf_fields):
        chunks = t._elem_chunks(x)  # a new array: it can serve as the copy
        hit = memo.get(name)
        if (hit is not None and isinstance(hit[0], np.ndarray) and hit[0].shape == chunks.shape
                and np.array_equal(hit[0], chunks)):
            return hit[1]
        root = t.root_from_chunks(chunks, len(x))
        memo[name] = (chunks, root)
        return root
    hit = memo.get(name)
    if hit is not None:
        snap, root = hit
        if isinstance(x, np.ndarray):
            same = (isinstance(snap, np.ndarray) and snap.dtype == x.dtype
                    and snap.shape == x.shape and np.array_equal(snap, x))
        else:
            same = isinstance(snap, list) and snap == x and all(
                type(e) is bytes or type(e) is int for e in x)
        if same:
            return root
    root = t.hash_tree_root(x)
    snap = _field_snapshot(x)
    if snap is not None:
        memo[name] = (snap, root)
    else:
        memo.pop(name, None)
    return root


def _leaf_setattr(self, name, value):
    """``__setattr__`` of ``_leaf_fields`` containers: drops the element's
    root memo, so a memo found on an element is the root of its current
    field values (memos are only made over immutable values)."""
    d = self.__dict__
    if "_root_memo" in d:
        del d["_root_memo"]
    object.__setattr__(self, name, value)


_IMMUTABLE = (bytes, int, np.integer, np.bool_)


def _field_key(t, v):
    """An immutable copy of a leaf field's value (the memo key)."""
    if isinstance(t, ByteVector):
        return bytes(v)
    return bool(v) if isinstance(t, Boolean) else int(v)


def _flat_container_encode(cls, values) -> bytes | None:
    """SSZ bytes of many ``_flat_fields`` containers, equal to joining each
    element's ``encode``: one [n, width] byte column per field, packed with
    numpy. A 2^20-validator registry encodes in a few passes over the list
    instead of 2^20 Python encodes. None when a value does not fit its field
    (the per-element encode then raises the error)."""
    n = len(values)
    cols = []
    for name, t in cls.FIELDS:
        vals = map(operator.attrgetter(name), values)
        if isinstance(t, ByteVector):
            parts = list(map(bytes, vals))
            if any(len(p) != t.length for p in parts):
                return None
            cols.append(np.frombuffer(b"".join(parts), np.uint8).reshape(n, t.length))
        elif isinstance(t, Boolean):
            cols.append(np.fromiter(map(bool, vals), np.uint8, n).reshape(n, 1))
        else:
            dt = np.dtype(_NP_DTYPE[t.byte_len]).newbyteorder("<")
            try:
                col = np.fromiter(map(int, vals), dt, n)
            except (OverflowError, ValueError):
                return None
            cols.append(col.view(np.uint8).reshape(n, t.byte_len))
    return np.concatenate(cols, axis=1).tobytes()


def _flat_container_roots(cls, values) -> np.ndarray:
    """Tree roots of many ``_leaf_fields`` containers, [n, 32].

    A 2^20-validator registry is 2^20 containers of 8 fields, and hashing
    each one alone (a Python call per field and per tree level) dominates a
    mainnet state root. Here each element keeps its root memoised while its
    field values are immutable objects and no field has been set since
    (``_leaf_setattr`` drops the memo), and the misses are hashed together,
    one ``sha256_pairs`` call per tree level. The roots equal the
    per-element ``hash_tree_root``; Lighthouse keeps a tree-hash cache for
    the same reason."""
    fields = cls.FIELDS
    get = operator.attrgetter(*cls._names)
    roots: list = [None] * len(values)
    miss, miss_keys, keep = [], [], []
    for i, v in enumerate(values):
        memo = v.__dict__.get("_root_memo")
        if memo is not None:
            roots[i] = memo
            continue
        raw = get(v)
        miss.append(i)
        keep.append(all(isinstance(x, _IMMUTABLE) for x in raw))
        miss_keys.append(tuple(_field_key(t, x) for (_, t), x in zip(fields, raw)))
    if miss:
        m, width = len(miss), next_pow2(len(fields))
        leaves = np.zeros((m, width, 32), np.uint8)
        for j, (_, t) in enumerate(fields):
            col = [k[j] for k in miss_keys]
            if isinstance(t, ByteVector):
                if t.length > 32:  # two chunks: one pair hash
                    pad = np.frombuffer(b"".join(c.ljust(64, b"\x00") for c in col), np.uint8)
                    leaves[:, j] = sha256_pairs(pad.reshape(m, 64))
                    continue
                raw = b"".join(c.ljust(32, b"\x00") for c in col)
            else:
                raw = b"".join(t.encode(c).ljust(32, b"\x00") for c in col)
            leaves[:, j] = np.frombuffer(raw, np.uint8).reshape(m, 32)
        level = leaves
        while level.shape[1] > 1:
            w = level.shape[1] // 2
            level = sha256_pairs(level.reshape(m * w, 64)).reshape(m, w, 32)
        for i, k, r in zip(miss, keep, level[:, 0]):
            root = r.tobytes()
            if k:
                values[i].__dict__["_root_memo"] = root
            roots[i] = root
    if not roots:
        return np.zeros((0, 32), np.uint8)
    return np.frombuffer(b"".join(roots), np.uint8).reshape(-1, 32)


def _val_eq(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and bool((a == b).all())
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_val_eq(x, y) for x, y in zip(a, b))
    return a == b


# -- free functions ---------------------------------------------------------------


def serialize(typ, value=None) -> bytes:
    if isinstance(typ, type) and issubclass(typ, Container):
        return typ.encode(value if value is not None else typ)
    if isinstance(typ, Container):
        return typ.serialize()
    return typ.encode(value)


def deserialize(typ, data: bytes):
    return typ.decode(data)


def hash_tree_root(typ, value=None) -> bytes:
    if isinstance(typ, Container):  # instance given directly
        return typ.tree_root()
    return typ.hash_tree_root(value)
