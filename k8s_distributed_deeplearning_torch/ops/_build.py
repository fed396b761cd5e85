"""Build the port's native sources and load them through ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel, compiled with nvcc) or
``csrc/<name>.cc`` (host code, compiled with ``c++``: the fusion planner)
exposes a plain C interface and is compiled on first use into
``build/lib<name>-<hash>.so`` inside the package (listed in
``.gitignore``), where ``<hash>`` covers the source, for a ``.cu`` every
``csrc/*.cuh`` header (the wgmma kernels share ``wgmma.cuh``), and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import time: the CPU tests import
every module of the port, and only a launch on a CUDA tensor (or a
fusion plan) reaches :func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        "kernels are compiled at first use and need the CUDA toolkit")


def _source(name: str) -> Path:
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cc"


def _compile_command(name: str, out: Path) -> list[str]:
    src = _source(name)
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"c++ not found on PATH: {src.name} is compiled "
                           "at first use and needs a C++ compiler")
    return [cxx, *CXX_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` or ``.cc`` builds: the name hashes the
    source, for a ``.cu`` every ``csrc/*.cuh`` in sorted order (names and
    contents), and the flags."""
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS if src.suffix == ".cu"
                      else CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu`` and
    ``csrc/*.cc``) that are not built yet, one compiler process per
    source, all started together.
    Returns name -> shared library path. The compiler's ``-Xptxas -v``
    report (registers, shared memory, spills) lands beside each library
    as ``.log``. Raises with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.c[cu]"))
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = _compile_command(name, tmp)
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        lib = todo[name]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"{_source(name).name} (exit {proc.returncode})"
                          f":\n{log}")
            continue
        os.replace(tmp, lib)       # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cc``, built on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib
