"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C entry point, under ``build/repro_torch/`` at the root of
the checkout.  The library name carries a hash of the sources and flags,
so an edited source builds anew and an unchanged one is reused.  All
sources compile in parallel, one ``nvcc`` process each.  Nothing is built
or loaded at import: the first kernel launch (or an explicit
:func:`build`) does it, so the CPU-only tests import this module freely.

The build never passes ``--use_fast_math``: ``div_deg`` is an IEEE
division, as in the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("decode_gqa", "edge_block", "push_ell", "segment_sum",
           "stream_fold")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)       # a host int array (a lane map)
# C signatures of each library's entry points: {symbol: argtypes}
_ENTRY = {
    "decode_gqa": {"decode_gqa_launch":
                   [_I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P,
                    _L, _L, _L, _L, _L, _L, _P, _L, _P, _P, _P, _P]},
    "edge_block": {"edge_block_reduce_launch":
                   [_I, _I, _I, _I, _I, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                    _L, _P, _P, _L, _I, _I, _P],
                   "edge_block_lanes_launch":
                   [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _IP, _I, _L,
                    _P, _P, _L, _P, _P, _L, _I, _L, _P, _I, _P],
                   "edge_block_fold_launch":
                   [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _IP, _I,
                    _L, _P, _P, _L, _P, _P, _L, _I, _I, _L, _P, _I, _P],
                   "edge_block_words_launch":
                   [_I, _P, _IP, _I, _L, _L, _P, _L, _L, _U, _P, _P, _P, _P,
                    _P, _P]},
    "push_ell": {"push_ell_message_launch":
                 [_I, _I, _I, _P, _P, _P, _P, _P, _L, _I, _P],
                 "push_ell_fused_launch":
                 [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                  _I, _L, _P],
                 "push_ell_lanes_launch":
                 [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _IP, _I, _L,
                  _P, _P, _P, _L, _I, _L, _I, _P]},
    "segment_sum": {"segment_reduce_launch":
                    [_I, _I, _I, _P, _P, _P, _P, _P, _P, _L, _L, _L, _P]},
    "stream_fold": {"stream_fold_launch":
                    [_I, _I, _I, _I, _P, _P, _P, _IP, _I, _L, _P, _P, _L, _P,
                     _P, _P, _L, _L, _I, _P]},
}

# Loaded libraries, one per source: a shared library is process-wide
# state once dlopen'ed, so the handles are cached for the process too.
_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``,
    or ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(ptxas_verbose: bool = False) -> dict:
    """Compile every source that has no library yet, all in parallel.

    Returns ``{"seconds": wall seconds, "built": [names], "ptxas": {name:
    compiler stderr}}``; ``ptxas_verbose`` adds ``-Xptxas=-v`` so the
    stderr lists each kernel's registers and spills.  Raises if a
    compile fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC),
               *(["-Xptxas=-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        logs[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)       # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "ptxas": logs}


def library(name: str):
    """The loaded ``csrc/<name>.cu`` library, built on first use."""
    if name not in _LOADED:
        path = library_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in _ENTRY[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return _LOADED[name]
