"""Milliseconds a query waited for a lane: the server's summed
submission-to-admission seconds (``counters()['queue_wait_s']``) over the
queries admitted to a lane (``['admitted']``) in the window."""


def read(rec):
    wait, admitted = (rec.counters.get("queue_wait_s"),
                      rec.counters.get("admitted"))
    if wait is None or not admitted:
        return None
    return 1e3 * wait / admitted
