"""Operator and measurement tools: ``db`` (database manager, lcli), ``vm``
(validator manager), ``time_rows``."""
