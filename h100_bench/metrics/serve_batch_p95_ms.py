"""serve_batch_p95_ms: the 95th percentile (nearest rank) over every batch
finished inside the window of the time from when the feed handed the batch
over to the fence of its outputs, in milliseconds."""

import math


def read(run):
    if run.kind != "serve":
        return None
    lat = sorted(u["latency_s"] for u in run.done())
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
