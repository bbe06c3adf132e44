"""Device-to-host reads (``GraphServer.counters()['host_reads']``) in
the window, per query the engine answered (landmark answers aside)."""


def read(rec):
    engine = sum(q["served_by"] != "landmark" for q in rec.queries)
    if not engine:
        return None
    return rec.counters["host_reads"] / engine
