"""Build and load the port's CUDA kernels (``grakel_torch/csrc/*.cu``)
and its native host engines (``grakel_torch/native/src/*.cpp``).

The sources have a plain C interface and no PyTorch headers, so each
compiles with ``nvcc`` in seconds.  At first use every source compiles
to an object file in its own ``nvcc`` process, all started together,
and the objects link into one shared library under ``build/kernels/``
at the root of the checkout, named by a hash of the sources and flags
(a changed source builds anew; an unchanged one loads the existing
library).  The library is loaded with ``ctypes``.

The native host engines (C++ for the CPU: clique enumeration, string
hashes, ODD-STh and NSPD decompositions, canonical labeling, ESU and
unit-weight BFS) build the same way with ``g++ -O3 -shared -fPIC
-std=c++17 -fopenmp`` into ``build/native/`` (:func:`build_native`), on
every machine, the CPU test runs included.  Without OpenMP (a compiler
that refuses ``-fopenmp``) they build single-threaded; any other
failure raises with the compiler's output.

Builds are safe to race: a process builds under an exclusive lock on a
file in the build directory, into a temporary directory there, and
moves the finished library into place with ``os.replace``, so a reader
never sees half a file and concurrent first uses (test workers) build
once.

Nothing here runs at import time: the CPU tests import every module,
and the CPU has neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

__all__ = ["load_library", "launch", "build_native", "CSRC", "BUILD_DIR",
           "NATIVE_SRC", "NATIVE_DIR"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NATIVE_SRC = os.path.join(_PKG, "native", "src")
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
# C entry points: name -> argtypes (every one returns cudaError_t as int)
_SIGNATURES = {
    "grakel_min_gram": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P],
    "grakel_min_gram_tc": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    "grakel_min_gram_tc_mma": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "grakel_threshold_expand": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P],
    "grakel_wl_hash_refine": [_P, _P, _P, _P, _I, _P],
    "grakel_wl_hash_refine_rows": [_P, _P, _P, _P, _I, _I, _P],
    "grakel_floyd_warshall": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "grakel_nh_round": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _P],
    "grakel_nh_graph": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                        _I, _P],
    "grakel_jaccard_fold": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "grakel_hadamard_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _P],
    "grakel_hadamard_graph": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                              _P],
    "grakel_canonical_codes": [_P, _P, _P, _I, _I, _I, _P],
    "grakel_rw_cg": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                     _F, _P, _I, _I, _P],
    "grakel_rw_cg_warp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _I, _F, _P, _P],
    "grakel_rw_spectral_gram": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _P, _L, _D, _P],
    "grakel_svm_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    "grakel_lovasz_dr_step": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I,
                              _I, _P],
    "grakel_lovasz_min_cone": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "grakel_lovasz_cone_quotient_check": [_P, _I, _P, _P],
    "grakel_lovasz_jacobi_eigh": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "grakel_csvc_smo": [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P],
    "grakel_csvc_vote": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _P, _P, _P, _P],
    "grakel_normalize_gram": [_P, _I, _P, _P, _P, _I, _I, _P],
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


def _digest(sources, flags=NVCC_FLAGS):
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmds, what="kernel"):
    """Run the commands in parallel; raise with the first failure's
    compiler output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("%s build failed (%d): %s\n%s"
                               % (what, p.returncode, " ".join(c), out))
    return outs


@contextlib.contextmanager
def _locked(directory):
    """An exclusive lock on ``directory/lock`` for the block (released by
    the kernel if the process dies, so a lock is never left stale)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


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


@functools.lru_cache(maxsize=None)
def _openmp_flags(gxx):
    """``["-fopenmp"]`` when ``gxx`` compiles and links an OpenMP probe,
    else ``[]``: the one failure a native build goes on from.  Probed
    once a process, in a temporary directory under the build
    directory."""
    os.makedirs(NATIVE_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=NATIVE_DIR) as tmp:
        probe = os.path.join(tmp, "omp_probe.cpp")
        with open(probe, "w") as f:
            f.write("#include <omp.h>\n"
                    "extern \"C\" int grakel_omp_probe() "
                    "{ return omp_get_max_threads(); }\n")
        p = subprocess.run([gxx, *GXX_FLAGS, "-fopenmp", probe, "-o",
                            os.path.join(tmp, "omp_probe.so")],
                           capture_output=True)
    return ["-fopenmp"] if p.returncode == 0 else []


def build_native():
    """Compile the native sources into
    ``build/native/libgrakel_native_<hash>.so`` (skipped when that file
    exists; the hash covers the sources and the recipe) and return its
    path.  Each source compiles in its own ``g++`` process, all started
    together; ``-fopenmp`` is dropped only when the compiler refuses it
    (an OpenMP probe fails), and the hash covers the flags used, so a
    single-threaded build is never loaded where OpenMP works.  Raises
    ``RuntimeError`` with the compiler's output on any other failure."""
    sources = sorted(glob.glob(os.path.join(NATIVE_SRC, "*.cpp")))
    if not sources:
        raise RuntimeError("no native sources under %s" % NATIVE_SRC)
    gxx = shutil.which("g++") or "g++"
    flags = GXX_FLAGS + _openmp_flags(gxx)
    lib = os.path.join(NATIVE_DIR, "libgrakel_native_%s.so"
                       % _digest(sources, flags))
    if os.path.exists(lib):
        return lib
    with _locked(NATIVE_DIR):
        if os.path.exists(lib):       # another process built it meanwhile
            return lib
        with tempfile.TemporaryDirectory(dir=NATIVE_DIR) as tmp:
            compile_flags = [f for f in flags if f != "-shared"]
            objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                    for s in sources]
            _run([[gxx, *compile_flags, "-c", s, "-o", o]
                  for s, o in zip(sources, objs)], "native")
            staged = os.path.join(tmp, "lib.so")
            _run([[gxx, *flags, *objs, "-o", staged]], "native")
            os.replace(staged, lib)
    return lib


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


def launch(name, device, *args):
    """Call the C entry point ``name(*args, stream)`` with ``device``
    current and its current stream's raw pointer as the last argument,
    and raise if it returned a CUDA error.  Switches device only when
    another one is current: the host side of a launch is most of a
    small kernel's cost."""
    import torch
    fn = getattr(load_library(), name)
    cur = torch.cuda.current_device()
    idx = cur if device.index is None else device.index
    if idx == cur:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    check(err, name)
