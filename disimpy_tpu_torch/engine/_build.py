"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use into a shared library under the package's ``build/`` directory (listed
in ``.gitignore``), named by a hash of the source, the shared headers
``csrc/*.cuh`` it may include and the flags, so an edited source or header
is rebuilt and an unchanged one is loaded as it is. The
library is loaded with ctypes. A missing nvcc or a failed build raises;
there is no fallback.
"""

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# Hopper only: sm_90a keeps wgmma/setmaxnreg available to later kernels.
# -Xptxas -v reports each kernel's registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

Built = collections.namedtuple("Built", "lib path seconds log")

# One lock per source: the parts of a split run may reach a kernel's first
# use from several threads at once, and must not run nvcc into the same
# temporary file; different sources still build side by side.
_guard = threading.Lock()
_locks = {}


def _lock_for(name):
    with _guard:
        return _locks.setdefault(name, threading.Lock())


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
        )
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError(
            "nvcc not found (on PATH or under $CUDA_HOME/bin): the CUDA "
            "kernels of disimpy_tpu_torch are built from source at first use"
        )
    return path


@functools.lru_cache(maxsize=None)
def load(name):
    """Build (if needed) and load ``csrc/<name>.cu``.

    Returns a :class:`Built` with the ctypes library, the library's path,
    the build's wall time in seconds (0.0 when an existing build was
    loaded) and nvcc's output (kept beside the library, so an existing
    build reports the output it was built with).
    """
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    log_path = path[:-len(".so")] + ".log"
    seconds, log = 0.0, ""
    with _lock_for(name):
        if os.path.exists(path) and os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
            with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
                f.write(log)
            # Atomic: concurrent builds never collide.
            os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
            os.replace(tmp, path)
    return Built(ctypes.CDLL(path), path, seconds, log)
