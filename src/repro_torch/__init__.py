"""PyTorch/CUDA port of the graph translator (counterpart of ``repro``)."""
__version__ = "0.1.0"
