"""Build and load the port's CUDA kernels (nvcc into a plain-C shared
library per kernel, loaded with ``ctypes``).

Each source ``repro_torch/kernels/<name>/csrc/*.cu`` compiles on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler
-fPIC -Xptxas -v -c``, one ``nvcc`` per source, all started together;
the objects of one kernel directory link into ``lib<name>-<hash>.so``
under ``build/repro_torch_kernels/`` at the root of the checkout.  The
file name carries a hash of the sources and flags, so editing a source
rebuilds the library and a stale one is never loaded.  The compiler's
``-Xptxas -v`` report (registers, spills and shared memory of each
kernel function) is kept beside the library (:func:`ptxas_report`).
:func:`build_all` compiles every kernel at once.

Every C entry point takes its pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``) and returns ``cudaGetLastError()`` after
its launch; :func:`check` raises on a non-zero value, because a refused
launch never runs and a later synchronise does not report it.

Each wrapper calls :func:`count` once where it launches its kernel, and
nowhere else; the counts are ``repro_torch.tracing``'s ``launch.<name>``
counters, so a pod tick's launches show among its counters.
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

from repro_torch import tracing

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def kernel_names() -> list[str]:
    """Every kernel directory that holds CUDA sources."""
    return sorted({p.parent.parent.name
                   for p in KERNELS_DIR.glob("*/csrc/*.cu")})


def _sources(name: str) -> list[Path]:
    csrc = KERNELS_DIR / name / "csrc"
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA source under {csrc}")
    return srcs


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted((KERNELS_DIR / name / "csrc").iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _start_build(name: str
                 ) -> tuple[Path, list[tuple[Path, subprocess.Popen]]] | None:
    """Start one ``nvcc -c`` per source of kernel ``name``; None if its
    library is built already."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in _sources(name):
        obj = out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    return out, jobs


def _finish_build(name: str, job) -> None:
    """Wait for the compiles of kernel ``name``, link its library and keep
    the compiler's report beside it."""
    out, jobs = job
    logs = [proc.communicate()[0] for _, proc in jobs]
    objs = [str(obj) for obj, _ in jobs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        if any(proc.returncode != 0 for _, proc in jobs):
            raise RuntimeError(f"nvcc failed for kernel {name!r}:\n"
                               + "\n".join(logs))
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking kernel {name!r} failed:\n"
                               f"{link.stdout}{link.stderr}")
        out.with_suffix(".ptxas.txt").write_text("\n".join(logs))
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            Path(obj).unlink(missing_ok=True)


def build_all() -> float:
    """Compile every kernel whose library is missing, all in parallel;
    returns the wall seconds the build took."""
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {n: _start_build(n) for n in kernel_names()}
        errors = []
        for n, job in jobs.items():
            if job is not None:
                try:
                    _finish_build(n, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> list[str]:
    """The compiler's ``-Xptxas -v`` report of kernel ``name``'s build
    (each kernel function's registers, spills and shared memory, and any
    warning), line by line; built first if needed."""
    load(name)
    text = _lib_path(name).with_suffix(".ptxas.txt").read_text()
    return [ln.strip() for ln in text.splitlines() if ln.strip()]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of kernel ``name`` with its argument types
    declared (pointers and the stream as ``c_void_p``) and an ``int``
    (``cudaError_t``) result; bound once, then reused."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def count(name: str) -> None:
    """Record one launch of kernel ``name``."""
    tracing.count("launch." + name)


def launch_counts() -> dict[str, int]:
    """Launches by kernel since the last :func:`reset_launch_counts`."""
    return {k[7:]: v for k, v in tracing.totals().items()
            if k.startswith("launch.")}


def reset_launch_counts() -> None:
    tracing.reset_totals("launch.")
