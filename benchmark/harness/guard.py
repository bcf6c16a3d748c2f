"""What a run may not load, and where its caches go.

The benchmark measures ``lighthouse_tpu_torch`` alone: no module of JAX, of
the JAX package ``lighthouse_tpu`` or of its ``bench.py`` may be loaded in the
process that prints the result. Names are compared whole, by their
top-level part (before the first dot), so ``lighthouse_tpu_torch`` passes
where ``lighthouse_tpu`` does not.
"""

from __future__ import annotations

import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lighthouse_tpu", "bench"})


def forbidden_loaded(modules=None) -> list:
    """Top-level names of loaded modules that the benchmark forbids."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def cache_env(cache_dir: str) -> None:
    """Fixed directories inside the checkout for every build and kernel
    cache a library might keep, set before anything is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(cache_dir, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
