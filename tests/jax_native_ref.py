"""The JAX package's native engine, loaded before a parity test compares
the port against it.

``grakel_tpu.native._load`` compiles ``_libgrakel_native.so`` with
``g++ -o`` straight into its final path, without a lock, and on any
failure keeps ``_lib = None`` for the rest of the process.  Test workers
that start together on a tree without the library can then load a file
another worker is still writing, and that worker's
``grakel_tpu.isomorphism.canonical_labeling`` (and every other native
entry point) quietly takes the Python engine for good: an isomorphic
but different labeling, and other hashes.  The port's parity tests
expect the native engine's values, so their modules use the
``jax_native`` fixture, which makes sure the engine is loaded:

* under an exclusive ``fcntl`` lock on a file in the temporary
  directory (the fixtures of concurrent workers build one at a time);
* a missing or stale library is built into a temporary file beside the
  final one (the JAX package's own recipe, ``native._build``) and moved
  into place with ``os.replace``, so no process loads half a file;
* then ``_tried`` is reset and ``_load`` run again, every half second
  for at most ``timeout`` seconds (a build started elsewhere, outside
  the lock, may still be writing the file);
* if it still does not load, the test fails with a plain message.
"""

import fcntl
import os
import tempfile
import time

import pytest

LOCK = os.path.join(tempfile.gettempdir(), "grakel_tpu_native_build.lock")


def _stale(jn):
    if not os.path.exists(jn._LIB_PATH):
        return True
    newest = max(os.path.getmtime(os.path.join(jn._SRC, f))
                 for f in os.listdir(jn._SRC))
    return os.path.getmtime(jn._LIB_PATH) < newest


def load_jax_native(timeout=120.0):
    """``grakel_tpu.native._lib``, loaded (see the module docstring)."""
    import grakel_tpu.native as jn
    if jn._lib is not None:
        return jn._lib
    deadline = time.monotonic() + timeout
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if _stale(jn):
                final = jn._LIB_PATH
                fd, staged = tempfile.mkstemp(
                    suffix=".so", dir=os.path.dirname(final))
                os.close(fd)
                try:
                    jn._LIB_PATH = staged
                    jn._build()
                    os.replace(staged, final)
                finally:
                    jn._LIB_PATH = final
                    if os.path.exists(staged):
                        os.unlink(staged)
            while True:
                jn._tried = False
                if jn._load() is not None:
                    return jn._lib
                if time.monotonic() > deadline:
                    break
                time.sleep(0.5)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    pytest.fail("grakel_tpu.native did not load its library %s within %g s; "
                "the parity tests compare against the native engine"
                % (jn._LIB_PATH, timeout))


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native engine, loaded for the whole module."""
    return load_jax_native()
