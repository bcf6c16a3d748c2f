"""Device light-client math: batched sync-committee update verification.

The port of ``lighthouse_tpu.ops.lc``, over the main path's stages
(``bls.backend``: h2c, masked aggregation, the security prologue, the ONE
combined pairing check per batch) and so over ``ops/bls``. Every curve op,
inversion, square root and pairing runs on the hand kernels of
``csrc/fused_mul.cu``.

* ``verify`` — the batched update-check stages: per-session participant
  pubkey aggregation as a bitfield-masked G1 sum over a device-resident
  per-period committee cache (heterogeneous periods gather different cache
  rows in the same dispatch), signature decompression + subgroup checks,
  random scaling, and one B+1-pair Miller product + one final
  exponentiation for the whole batch.
"""

from . import verify  # noqa: F401
