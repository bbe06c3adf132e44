"""Graph generators: ``bench/generators/<name>.py`` with ``make(config,
seed, device)``, found by the ``generator`` a configuration names."""
