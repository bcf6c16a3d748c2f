"""Device KZG math: scalar-field (Fr) limb ops and the batched cell verify.

The port of ``lighthouse_tpu.ops.kzg``, over the port's ``ops/bls``: the
25x16-bit limb layout and ``fq.conv_product`` (the digit convolution as
integer broadcast multiply-sums), ``curve.scale_bits``/``point_sum`` for the
MSMs, and ``pairing.multi_pairing_is_one`` for the one combined pairing
check per batch. Every curve op, inversion and pairing runs on the hand
kernels of ``csrc/fused_mul.cu``; the Fr math is PyTorch, as it is jnp
outside the Pallas kernel in the reference.

* ``frops``  — Fr arithmetic in the limb domain: products through the conv,
  dot products as summed digit outer products, and the fold / normalize /
  conditional-subtract reduction mod r, every bound proved below 2^63
  through ``fq._cert`` under ``kzg.*`` kinds.
* ``verify`` — the batched cell-proof check: interpolation (a static
  permutation gather, one shared inverse-NTT matrix, a per-coset descale),
  the random-linear-combination aggregation, one ``scale_bits`` ladder over
  every scalar multiply, and ONE 2-pair Miller product.
"""

from . import frops, verify  # noqa: F401
