"""Traffic drivers: ``bench/drivers/<name>.py`` with a class ``Driver``,
found by the ``driver`` a traffic mix names."""
