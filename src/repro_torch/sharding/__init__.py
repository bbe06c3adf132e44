"""Logical-axis sharding: the rule tables, the resolver and the port's
``PartitionSpec``/``NamedSharding`` (counterpart of ``repro.sharding``)."""
