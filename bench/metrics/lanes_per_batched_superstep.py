"""Lanes a batched superstep stepped, on average over the window:
``counters()['lane_steps']`` over ``['batched_supersteps']``."""


def read(rec):
    lanes, steps = (rec.counters.get("lane_steps"),
                    rec.counters.get("batched_supersteps"))
    if lanes is None or not steps:
        return None
    return lanes / steps
