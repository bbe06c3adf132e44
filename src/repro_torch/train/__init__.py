"""Training substrate: optimizers, the microbatched step, checkpoints
(counterpart of ``repro.train``)."""
