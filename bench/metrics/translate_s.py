"""Seconds of ``translate`` outside its layouts: ``translate_breakdown``
passes_s + analysis_s + build_s + emit_s, summed over the programs the
cell's driver holds."""


def read(rec):
    return rec.translate_s
