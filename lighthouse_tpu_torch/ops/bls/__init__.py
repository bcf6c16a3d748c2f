"""BLS12-381 limb arithmetic on int64 tensors: the port of ``lighthouse_tpu.ops.bls``."""
