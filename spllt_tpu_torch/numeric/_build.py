"""Compiles and loads the hand-written CUDA kernels.

The sources in ``spllt_tpu_torch/csrc/*.cu`` have a plain C interface
(``extern "C"``: pointers, ints and the stream; each entry point returns
``cudaGetLastError()``); the ``*.cuh`` headers beside them hold the device
functions that the batched and the stream kernels share.  At first use every source is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under
``spllt_tpu_torch/_build/`` — one compiler process per source, all started
together — and loaded with ``ctypes``.  Library names carry a hash of the
source, the headers and the flags, so an edited source or header is rebuilt
and a built one is reused.  Nothing is built when the package is imported: a machine without
``nvcc`` imports every module and runs the plain versions on CPU tensors.

:func:`build_capi` builds the C interface's library the same way, with the
host C++ compiler: ``native/capi.cpp`` against ``include/spllt_tpu.h`` and
the embedding flags of ``python3-config``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time

__all__ = ["KERNEL_SOURCES", "build_all", "load", "check_launch",
           "require_cuda_tensors", "build_capi", "build_c_program",
           "embedded_env", "CAPI_INCLUDE"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_OUT = os.path.join(_PKG, "_build")
_CAPI_SOURCE = os.path.join(_PKG, "native", "capi.cpp")
# the C header of the interface (include/spllt_tpu.h beside the package)
CAPI_INCLUDE = os.path.join(os.path.dirname(_PKG), "include")

KERNEL_SOURCES = {
    "potrf": "potrf.cu",
    "trsm": "trsm.cu",
    "update": "update.cu",
    "solve": "solve.cu",
    "mega_factor": "mega_factor.cu",
    "mega_solve": "mega_solve.cu",
}

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-I", _CSRC]

_libs: dict = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of spllt_tpu_torch cannot be built on this machine")


def _source_path(name: str) -> str:
    return os.path.join(_CSRC, KERNEL_SOURCES[name])


def _lib_path(name: str) -> str:
    """The library of source ``name``, keyed by a hash of the source, of
    every header in ``csrc/`` it could include, and of the flags (the
    include path is hashed by its role, not by where the package lies)."""
    h = hashlib.sha256(" ".join(_FLAGS[:-1]).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [_source_path(name)] + [os.path.join(_CSRC, f)
                                        for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_OUT, f"libspllt_{name}_{h.hexdigest()[:16]}.so")


def build_all() -> float:
    """Compile every kernel source that has no up-to-date library yet, in
    parallel.  Returns the seconds it took (0.0 when nothing was stale).
    A failed compile raises with the compiler's output."""
    todo = [n for n in KERNEL_SOURCES if not os.path.exists(_lib_path(n))]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    os.makedirs(_OUT, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        tmp = _lib_path(n) + f".tmp{os.getpid()}"
        cmd = [nvcc, *_FLAGS, "-o", tmp, _source_path(n)]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {KERNEL_SOURCES[n]} "
                          f"(exit {p.returncode}):\n{out}")
            continue
        os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The shared library of kernel ``name`` (built on demand).
    ``signatures`` maps each entry point to its ctypes argument types;
    every entry point returns the launch status as an int."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check_launch(status: int, what: str) -> None:
    """Raise when a kernel launch was refused (the launch then never ran,
    and a later synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with status "
                           f"{status} (cudaError_t)")


def require_cuda_tensors(what: str, *tensors) -> None:
    """Kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected tensors on {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _python_config() -> str:
    """The ``python3-config`` of the running interpreter's version."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    for c in (sys.executable + "-config", shutil.which(f"python{ver}-config"),
              shutil.which("python3-config")):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("python3-config not found: the C interface's "
                       "library cannot be built on this machine")


def build_capi() -> str:
    """Compile ``native/capi.cpp`` into the C interface's shared library
    under ``_build/`` unless an up-to-date one is there (keyed by a hash of
    the source, the header and the flags), and return its path.  The
    embedded interpreter needs ``PYTHONPATH`` to name the package's parent
    directory and the directories of torch and numpy.  A failed compile
    raises with the compiler's output."""
    cfg = _python_config()

    def config(*args):
        return subprocess.run([cfg, *args], capture_output=True, text=True,
                              check=True).stdout.split()

    ldflags = config("--ldflags", "--embed")
    # find libpython at run time where the link found it
    rpath = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    flags = (["-O2", "-shared", "-fPIC", "-std=c++17", "-I", CAPI_INCLUDE]
             + config("--includes"))
    libs = ldflags + rpath
    h = hashlib.sha256(" ".join(flags + libs).encode())
    for path in (_CAPI_SOURCE, os.path.join(CAPI_INCLUDE, "spllt_tpu.h")):
        with open(path, "rb") as f:
            h.update(f.read())
    lib = os.path.join(_OUT, f"libspllt_tpu_torch_c_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_OUT, exist_ok=True)
    tmp = lib + f".tmp{os.getpid()}"
    p = subprocess.run([os.environ.get("CXX", "g++"), *flags, "-o", tmp,
                        _CAPI_SOURCE, *libs], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"g++ failed on native/capi.cpp (exit "
                           f"{p.returncode}):\n{p.stdout}{p.stderr}")
    os.replace(tmp, lib)
    return lib


def build_c_program(source: str, out: str) -> str:
    """Compile and link the C program ``source`` (e.g.
    ``examples/c/simple.c``) against the C interface's library (built by
    :func:`build_capi` if needed) into ``out``; returns ``out``."""
    lib = build_capi()
    p = subprocess.run([os.environ.get("CC", "gcc"), "-O2", "-I", CAPI_INCLUDE,
                        "-o", out, source, lib,
                        f"-Wl,-rpath,{os.path.dirname(lib)}", "-lm"],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"gcc failed on {source} (exit {p.returncode}):"
                           f"\n{p.stdout}{p.stderr}")
    return out


def embedded_env(**extra) -> dict:
    """The environment of a C program that embeds this interpreter: the
    running process's, with ``PYTHONPATH`` naming the package's parent and
    every directory of ``sys.path`` (where torch and numpy lie), plus
    ``extra``."""
    path = [os.path.dirname(_PKG)] + [p for p in sys.path if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path), **extra)
