# Command-line drivers: the LM server (serve.py).
