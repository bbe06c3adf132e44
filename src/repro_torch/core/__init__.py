# The translator path of the port: the graph DSL (dsl.py), the IR and its
# passes (ir.py, passes.py, analysis.py), the translator (translator.py)
# with its runtime scheduler (scheduler.py) and communication manager
# (comm.py), over CSR/ELL graph layouts (graph.py) built host-side
# (preprocess.py), and the algorithm library (algorithms.py).
from . import algorithms, comm, dsl, graph, preprocess, scheduler
from .translator import translate

__all__ = ["algorithms", "comm", "dsl", "graph", "preprocess", "scheduler",
           "translate"]
