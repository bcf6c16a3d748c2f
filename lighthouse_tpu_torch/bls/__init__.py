"""Batched BLS signature verification on the device: the port of
``lighthouse_tpu.bls.tpu_backend`` (single device) and its byte codecs."""
