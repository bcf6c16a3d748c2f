"""Native (C++) BLS12-381 backend: the port's copy of ``lighthouse_tpu/native``.

``bls12_381.cpp`` is the CPU parity backend behind ``bls.set_backend("native")``
(the role blst plays in Lighthouse, ``crypto/bls/Cargo.toml``'s supranational
feature). It is built with ``g++`` at first use into
``lighthouse_tpu_torch/_build/native/`` and loaded through ctypes.
"""

from .build import BUILD_DIR, NativeBls, load_bls  # noqa: F401
