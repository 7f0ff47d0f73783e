"""Build and load the port's hand-written CUDA kernels.

Each source in ../csrc is compiled by `nvcc` for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes.  No PyTorch
headers are included, so a build takes seconds.  Libraries land in
../_build (listed in .gitignore), named by a hash of the flags, the
source and every ../csrc header it includes (`#include "x.cuh"`,
followed recursively), so editing a source or one of its headers
rebuilds it and an unchanged one is reused.
Nothing is built at import: the first call that needs a library builds
it, or `build_all()` builds every source at once, one nvcc process per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
SOURCES = ("blend", "blend_bwd", "fisher", "nn1")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _source_closure(path: Path, seen: dict[Path, bytes]) -> None:
    """The bytes of `path` and of every csrc header it includes."""
    if path in seen:
        return
    seen[path] = text = path.read_bytes()
    for inc in _INCLUDE.findall(text):
        header = CSRC / inc.decode()
        if header.exists():
            _source_closure(header, seen)


def _lib_path(name: str) -> Path:
    seen: dict[Path, bytes] = {}
    _source_closure(CSRC / f"{name}.cu", seen)
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(seen):
        h.update(path.name.encode() + b"\0" + seen[path])
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every named source not yet built, in parallel.  Returns
    {name: {"path", "seconds", "log"}}; raises with nvcc's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    out = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = dict(path=str(path), seconds=0.0, log="(cached)")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (path, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (path, tmp, t0, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = dict(path=str(path), seconds=time.perf_counter() - t0,
                         log=log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
