"""Operator and measurement tools: ``db`` (database manager, lcli), ``time_rows``."""
