"""lighthouse_tpu_torch: the PyTorch/CUDA port of ``lighthouse_tpu``'s device path.

The JAX package ``lighthouse_tpu`` stays the reference; this package is its
port to one NVIDIA Hopper GPU. It imports ``torch`` and numpy only — never
``jax`` and nothing of ``lighthouse_tpu`` (what it needs of the reference's
framework-free modules lives here as its own copy, pinned by tests).

The first slice ports batched BLS12-381 signature-set verification
(``bls.backend.verify_indexed_sets_device``). Every field multiply on that
path runs through the two hand-written CUDA kernels of ``csrc/fused_mul.cu``
(bound in ``ops/bls/fused_mul.py``), the port of the reference's only Pallas
kernel: the plan kernel (one multiply step, input lincombs included) and the
chain kernel (a whole fixed-exponent chain in one launch).

Device rule: every entry point takes ``device=``; the default is CUDA, and
with no CUDA device the default raises — nothing drops to the CPU unless the
caller asks for it (the CPU tests pass ``device="cpu"``). Importing the
package touches no device.
"""

from .device import resolve_device  # noqa: F401
