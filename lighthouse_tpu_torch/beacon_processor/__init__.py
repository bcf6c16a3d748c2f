"""The port's beacon-processor table (``WorkType``); the scheduler is not
ported."""

from .processor import WorkType  # noqa: F401
