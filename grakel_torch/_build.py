"""Build and load the port's CUDA kernels (``grakel_torch/csrc/*.cu``).

The sources have a plain C interface and no PyTorch headers, so each
compiles with ``nvcc`` in seconds.  At first use every source compiles
to an object file in its own ``nvcc`` process, all started together,
and the objects link into one shared library under ``build/kernels/``
at the root of the checkout, named by a hash of the sources and flags
(a changed source builds anew; an unchanged one loads the existing
library).  The library is loaded with ``ctypes``.

Nothing here runs at import time: the CPU tests import every module,
and the CPU has neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

__all__ = ["load_library", "CSRC", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns cudaError_t as int)
_SIGNATURES = {
    "grakel_min_gram": [_P, _P, _P, _I, _I, _I, _P],
    "grakel_wl_hash_refine": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels of grakel_torch build on a machine "
                           "with the CUDA toolkit")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands in parallel; raise with the first failure's
    compiler output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("kernel build failed (%d): %s\n%s"
                               % (p.returncode, " ".join(c), out))
    return outs


def build(verbose=False):
    """Compile the sources into ``build/kernels/libgrakel_torch_<hash>.so``
    (skipped when that file exists) and return its path.  ``verbose``
    adds ``-Xptxas -v`` and returns the compiler output too."""
    sources = _sources()
    if not sources:
        raise RuntimeError("no CUDA sources under %s" % CSRC)
    lib = os.path.join(BUILD_DIR, "libgrakel_torch_%s.so" % _digest(sources))
    if os.path.exists(lib) and not verbose:
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in sources]
        outs = _run([[nvcc, *NVCC_FLAGS, *extra, "-c", s, "-o", o]
                     for s, o in zip(sources, objs)])
        staged = os.path.join(tmp, "lib.so")
        outs += _run([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", staged]])
        os.replace(staged, lib)   # atomic: a reader never sees half a file
    return lib, "".join(outs)


def load_library():
    """The loaded kernel library (built on first call), with argtypes and
    restype declared for every C entry point."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def check(err, name):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, err))
