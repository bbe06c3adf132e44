"""The benchmark's yardstick: what every cell shares.

The deployment of a configuration, the reduction of spans and traces to
metrics, the table of peaks, the byte counts, the sample and the
comparison that decides ``correct``.  Configurations and traffic mixes
are data; generators, drivers, kinds of query (each with its plain
reference) and metric readers are small files beside it, found by name
(see ``spec``).
"""
