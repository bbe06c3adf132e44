"""Plain references of the served computations, in PyTorch alone.

They read the edge list the benchmark generated, never anything the
program built, and import nothing of the program.
"""
