"""Run the port's compilers: ``nvcc`` for the kernels (``ops/build.py``) and
the host C++ compiler for the host libraries of ``csrc/host/`` (the native
PESQ and composite measures, ``eval/pesq_native.py``), each into a file
named by a digest of its sources, headers and flags under ``build/``.
This module imports no torch: the scoring workers that load the host
library import numpy and scipy only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

HOST_SRC_DIR = Path(__file__).resolve().parents[1] / "csrc" / "host"
HOST_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
# the JAX package's native/Makefile's flags
HOST_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LOADED: dict = {}


def compile_all(jobs: dict, what: str) -> dict:
    """Run each ``{name: (command, output path)}`` whose output does not exist
    yet, all started together, each writing a temporary file that replaces
    the output only when its command succeeds (so a process that finds the
    library finds it whole).  Returns ``{name: compiler output}`` for the
    ones run; raises if any fails."""
    running = {}
    for name, (cmd, out) in jobs.items():
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: {Path(proc.args[0]).name} exit {proc.returncode}\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError(f"{what} build failed:\n" + "\n".join(failed))
    return logs


def host_library_path(name: str, sources) -> Path:
    """``build/host/lib<name>-<digest>.so``; the digest covers ``sources``,
    every header of ``csrc/host/`` and the flags."""
    src = b"".join((HOST_SRC_DIR / f).read_bytes() for f in sources)
    src += b"".join(p.read_bytes() for p in sorted(HOST_SRC_DIR.glob("*.h")))
    digest = hashlib.sha1(src + " ".join(HOST_CXX_FLAGS).encode()).hexdigest()[:12]
    return HOST_BUILD_DIR / f"lib{name}-{digest}.so"


def _cxx() -> str:
    path = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not path:
        raise RuntimeError("no host C++ compiler: set CXX or put c++ or g++ on PATH")
    return path


def load_host(name: str, sources) -> ctypes.CDLL:
    """The host library ``name`` compiled from ``sources`` (file names in
    ``csrc/host/``) with the host C++ compiler, built first if needed;
    raises if the build fails."""
    path = host_library_path(name, sources)
    lib = _LOADED.get(path)
    if lib is None:
        cmd = [_cxx(), *HOST_CXX_FLAGS, *(str(HOST_SRC_DIR / f) for f in sources), "-lm"]
        compile_all({name: (cmd, path)}, "host library")
        lib = ctypes.CDLL(str(path))
        _LOADED[path] = lib
    return lib
