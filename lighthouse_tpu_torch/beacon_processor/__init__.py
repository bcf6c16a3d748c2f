"""Work scheduler (Lighthouse beacon_node/beacon_processor): the port's copy
of ``lighthouse_tpu/beacon_processor``."""

from .processor import (
    BeaconProcessor,
    BeaconProcessorConfig,
    Work,
    WorkType,
    QueueLengths,
)
from .reprocess import ReprocessQueue
