"""Set-up seconds: from the process's start to the window's, with the
graph made, handed to the port, translated and warmed up (and, in a
run that builds them, the CUDA kernels compiled)."""


def read(rec):
    return rec.setup_s
