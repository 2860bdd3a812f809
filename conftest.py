"""Session set-up shared by every test directory.

The JAX package's native I/O runtime (native/, bound by
octree_slam_tpu/io/native.py) is built lazily: the first call to
`native.available()` runs `make -C native` when native/build holds no
library. tests/test_native.py makes that call while it is imported, to
decide its skip. Under pytest-xdist every worker imports every test file,
so on a tree without native/build all the workers would run `make` into the
same directory at once. A worker that then found a half-written library
either skipped the native tests or failed to import it; the workers then
collected different tests, and xdist ran none.

So the controlling process builds the library once, before any worker
starts, and holds an exclusive lock while it does. A build that fails (no
compiler, no libpng headers) leaves the tests to skip as they would have.
This file imports neither jax nor torch.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")


def _build_native() -> None:
    build = os.path.join(_NATIVE_DIR, "build")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                           timeout=300, check=False)
        except (OSError, subprocess.TimeoutExpired):
            pass


def pytest_configure(config):
    # an xdist worker has `workerinput`; the controller (or a run without
    # xdist) builds before any test file is imported
    if not hasattr(config, "workerinput"):
        _build_native()
