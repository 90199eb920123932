"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``kernels/csrc/<name>.cu`` compiles on its own into
``build/repro_torch/<name>-<key>.so`` under the repository root, where
``<key>`` hashes the source and the compiler flags: an edited source
builds anew, an unchanged one loads from disk.  The sources expose plain
C entry points (no PyTorch headers), so a build takes seconds.  Each entry
point launches on the stream it is given and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero code into an exception.

Each source keeps a table of its builds (``csrc/builds.cuh``): its
``<name>_init`` grants each its dynamic shared memory, and
``<name>_attributes`` reads one build's attributes on the card
(:func:`attributes`, the checker's rule H004).

Nothing here runs at import time: the CPU tests import every module on a
host with no ``nvcc``.  A build that fails raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("plane_scores", "plane_select", "viterbi", "moe_ffn",
           "flash_attention", "gram", "approx_pass")
# Shared memory a CTA may opt into on Hopper (227 KB of the SM's 256 KB):
# the one constant the plans, the sources (``REPRO_SMEM_LIMIT``) and the
# checker read.
SMEM_LIMIT = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DREPRO_SMEM_LIMIT={SMEM_LIMIT}")
# The fields ``<name>_attributes`` writes (csrc/builds.cuh).
ATTRIBUTES = ("registers", "static_smem", "local_bytes", "max_threads",
              "max_dyn_smem", "resident", "binary_version", "builds")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    """``build/repro_torch`` under the repository root (git-ignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the repro_torch CUDA kernels cannot be built")


def _key(name: str) -> str:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{_key(name)}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources that are not built yet, all at once.

    One ``nvcc`` process per source, started together.  Returns the
    seconds each compile took (0.0 for a library already on disk).  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<name>-<key>.log``.
    """
    names = tuple(SOURCES if names is None else names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def attributes(name: str, index: int, threads: int = 0, dyn_smem: int = 0,
               cluster: int = 1) -> Dict[str, int]:
    """Build ``index`` of ``csrc/<name>.cu``'s table, read on the card
    after the source's init (:data:`ATTRIBUTES`, and ``rc``: the call's
    cudaError_t).  With ``threads`` > 0, ``resident`` is the CTAs of that
    many threads and ``dyn_smem`` dynamic shared bytes one SM holds at
    once, or with ``cluster`` > 1 the clusters the card places at once;
    else -1.  The library must be loaded and initialised (its module's
    ``_lib()``)."""
    fn = getattr(load(name), f"{name}_attributes")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(ATTRIBUTES))(*([-1] * len(ATTRIBUTES)))
    rc = fn(index, threads, dyn_smem, cluster, out)
    return dict(zip(ATTRIBUTES, out), rc=rc)


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError "
                           f"{rc}")
