"""Spec-conformance runner: the port's copy of ``lighthouse_tpu/conformance``.

Lighthouse pins its state transition and BLS backends to the official
``consensus-spec-tests`` vectors via a Handler/Case runner
(``testing/ef_tests/src/handler.rs:13-99``) plus a script asserting every
vector file on disk was consumed (``Makefile:126-131``,
``check_all_files_accessed.py``). The repo's vectors are golden vectors
checked in under ``tests/vectors/`` (``generate.py`` writes the same
families); ``handler.run_all(device=...)`` walks the tree with the same
all-files-consumed discipline, so silently skipped coverage is impossible.

Layout (mirrors consensus-spec-tests):
    tests/vectors/<config>/<fork>/<runner>/<handler>/<case>/...
"""

from .handler import ConformanceError, default_vector_root, run_all  # noqa: F401
