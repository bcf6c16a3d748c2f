"""Watch: standalone chain-analytics service (Lighthouse's ``watch/``, 6,461
LoC): the port's copy of ``lighthouse_tpu/watch/``.

The reference ingests the canonical chain into PostgreSQL via the Beacon API
and serves an HTTP query surface; here the database is stdlib SQLite (no
postgres server is assumed) with the same shape: an updater that
backfills + follows canonical slots through the standard API, block metadata
extraction (proposer, attestation/deposit counts, graffiti, vote
participation), and a query API.

    db = WatchDB(path)
    svc = WatchService(db, beacon_url)
    svc.update()             # backfill + follow head
    server = WatchServer(db).start()   # /v1/slots/..., /v1/blocks/...
"""

from .db import WatchDB
from .server import WatchServer
from .service import WatchService

__all__ = ["WatchDB", "WatchServer", "WatchService"]
