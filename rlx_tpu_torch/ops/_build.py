"""Build the CUDA sources in ``rlx_tpu_torch/csrc``, and the host C++ of the
native env batcher, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/rlx_tpu_torch/<name>-<hash>.so`` at the repository root (git
ignores ``build/``) and loaded with ``ctypes``.  The file name carries a
hash of the source, so an edited source is rebuilt and a stale library is
never loaded.  All missing libraries are compiled together, one ``nvcc``
process per source.

The host C++ sources (``environments/native/envbatch*.cpp``) are compiled
by ``g++`` one at a time when an env first needs one (``load_host``), into
the same directory and under the same naming; ``build_all`` never touches
them, so a machine without ``nvcc`` runs the native envs.
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

HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

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


def build_dir():
    """The build directory, created if missing (also where a native env's
    compiled MuJoCo model goes)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def host_library_path(source, compile_flags=(), link_flags=()):
    """``build/rlx_tpu_torch/<name>-<hash>.so`` of a host C++ source: the hash
    covers the source, the compiler and linker flags (the MuJoCo builds name
    the ``libmujoco`` file they link), so a change to any of them rebuilds."""
    with open(source, "rb") as f:
        text = f.read()
    flags = " ".join([*HOST_FLAGS, *compile_flags, "|", *link_flags])
    digest = hashlib.sha256(text + flags.encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def load_host(source, compile_flags=(), link_flags=()):
    """The ``ctypes`` library of a host C++ source, compiled by ``g++`` with
    ``HOST_FLAGS`` if its library is missing.  Each process writes its own
    temporary file and renames it into place, so processes that build at
    once (test workers) never load a half-written library.  A failed
    compile raises with the compiler's output."""
    path = host_library_path(source, compile_flags, link_flags)
    if path not in _loaded:
        if not os.path.exists(path):
            build_dir()
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = ["g++", *HOST_FLAGS, *compile_flags, "-o", tmp, source, *link_flags]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {os.path.basename(source)} ({' '.join(cmd)}):\n{proc.stdout}")
            os.replace(tmp, path)
        _loaded[path] = ctypes.CDLL(path)
    return _loaded[path]
