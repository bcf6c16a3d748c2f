"""Device operations of the port (torch tensors; kernels under ``csrc/``)."""
