"""Host utilities of the port (its copy of ``lighthouse_tpu/utils``, as far
as the ported modules need it)."""
