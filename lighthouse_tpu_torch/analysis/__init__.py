"""Static analysis: machine-checked kernel, memory and concurrency proofs.

The port of ``lighthouse_tpu/analysis``. Six passes, run in the tier-1
tests (``tests/test_torch_analysis_*.py``), on the card by
``chip_smoke.py`` phase 24, and by hand via
``python -m lighthouse_tpu_torch.analysis [--device cpu]``:

* **Pass 1 — limb-bound certifier** (``bounds.py``): every op graph runs
  abstractly on the ``meta`` device with a certification sink installed in
  ``ops/bls/fq.py``, so every statically derived bound (the digit
  schedules, lincomb budgets, reduction walks, each launch's shared memory)
  is recorded as a (proven, declared) obligation; a cache hit replays what
  its derivation proved. Emits ``BOUNDS_CERT.json``.
* **Pass 2 — host-sync linter** (``hygiene.py``): an AST pass over the
  device-path modules flagging host reads and Python branches on tensors
  and unhashable arguments to the cached builders, with a
  ``# lint: allow(<rule>)`` pragma and a checked-in baseline; its rider,
  the durability lint (``durability.py``), flags multi-key persistence
  sequences outside one atomic batch.
* **Pass 3 — build sentinel** (``recompile.py``): counters of what a warm
  loop must not redo (schedules derived, plan-cache misses, table and
  constant uploads, builder misses, loads and builds of the kernels'
  library); a steady-state loop builds nothing.
* **Pass 4 — supervisor-transparency probe** (``supervised.py``): the
  resilience wrappers lint clean, add no build, return the kernel's result
  bit for bit, and run it on the operands' CUDA device.
* **Pass 5 — concurrency certifier** (``concurrency.py``): lock-discipline
  proofs over every module importing ``threading``, an acyclic
  acquires-while-holding graph, blocking calls under locks, and a runtime
  lockdep turned on by ``install()``. Emits ``CONCURRENCY_CERT.json``.
* **Pass 6 — device-memory certifier and footprint planner**
  (``memory.py``): graph footprints by a liveness walk over the meta
  execution, the shared-memory walk of every schedule, the five residency
  models, the H100 tier and the ``max_safe_shape`` planner. Emits
  ``MEMORY_CERT.json``.

The certificates land under ``lighthouse_tpu_torch/_build/analysis/``. The
package imports torch, numpy and the standard library only, and reads no
environment variable.
"""

from .bounds import certify, certify_callable, write_cert  # noqa: F401
from .concurrency import (  # noqa: F401
    certify_concurrency,
    install,
    lockdep_enabled,
    merge_observed,
    uninstall,
)
from .hygiene import lint_tree  # noqa: F401
from .memory import (  # noqa: F401
    DEVICE_TIERS,
    certify_memory,
    epoch_mirror_bytes,
    fault_memory_context,
    firehose_staging_bytes,
    kzg_table_bytes,
    lc_committee_cache_bytes,
    max_safe_shape,
    rung_fit,
    slasher_span_bytes,
)
from .recompile import BuildSentinel, recompile_probe, steady_state_builds  # noqa: F401
