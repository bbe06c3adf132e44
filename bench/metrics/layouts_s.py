"""Host seconds the port's ``GraphLayouts`` spent building layouts
(``stats()['build_times_s']`` summed over every graph it holds)."""


def read(rec):
    return rec.layouts_s
