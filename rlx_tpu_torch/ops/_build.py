"""Build the CUDA sources in ``rlx_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/rlx_tpu_torch/<name>-<hash>.so`` at the repository root (git
ignores ``build/``) and loaded with ``ctypes``.  The file name carries a
hash of the source, so an edited source is rebuilt and a stale library is
never loaded.  All missing libraries are compiled together, one ``nvcc``
process per source.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "rlx_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded = {}

# A kernel's launch shape as its wrapper computes it: grid and block size,
# dynamic shared memory per block, and the chunks of work each block walks.
Launch = collections.namedtuple("Launch", "blocks threads shared_bytes chunks")


def _nvcc():
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def sources():
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def library_path(name):
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build_all():
    """Compile every source whose library is missing, all at once.

    Returns ``{name: (seconds, compiler_output)}`` for what was compiled
    (the output holds ``ptxas``'s register and spill report).  Raises if any
    compile fails."""
    todo = [n for n in sources() if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, time.perf_counter())
    report, failures = {}, []
    for name, (proc, tmp, start) in procs.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{output}")
            continue
        os.replace(tmp, library_path(name))
        report[name] = (seconds, output)
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def load(name):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not os.path.exists(path):
            build_all()
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
