"""Mean push + pull supersteps of a search (``run_stats``, exact)."""


def read(rec):
    if not rec.searches:
        return None
    return sum(s["supersteps"] for s in rec.searches) / len(rec.searches)
