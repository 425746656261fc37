"""Build-and-load of the port's native sources under ``csrc/``.

Each source becomes one shared library with a plain C interface, compiled at
first use (nvcc for the CUDA kernels, g++ for host code), keyed by a hash of
the source and the flags, into ``_build/`` beside the package, and bound with
ctypes. Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the flags of native/Makefile: no -march, no fast-math, so the host builder
# rounds the same on every x86-64 machine
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ on a machine with the CUDA toolkit")


def gxx() -> str:
    cand = shutil.which(os.environ.get("CXX", "g++"))
    if not cand:
        raise RuntimeError("no C++ compiler (g++) found for csrc/ host code")
    return cand


class Library:
    """One source of ``csrc/`` as a ctypes library. ``bind(lib)`` declares
    the argument and result types of its C functions; `headers` names the
    files of ``csrc/`` it includes, which the build's hash covers too."""

    def __init__(self, source: str, compiler: Callable[[], str],
                 flags: Sequence[str], bind: Callable[[ctypes.CDLL], None],
                 headers: Sequence[str] = ()):
        self.source = CSRC / source
        self.headers = tuple(CSRC / h for h in headers)
        self.compiler = compiler
        self.flags = tuple(flags)
        self.bind = bind
        self.build_log = ""  # the compiler's output, where this process built
        self.path: Optional[Path] = None  # the loaded library's file
        self._lib: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        """Build (once per hash of source and flags) and load the library."""
        if self._lib is not None:
            return self._lib
        text = b"".join(f.read_bytes() for f in (self.source, *self.headers))
        key = hashlib.sha256(text + " ".join(self.flags).encode()
                             ).hexdigest()[:16]
        so = BUILD_DIR / f"{self.source.stem}_{key}.so"
        if not so.exists():
            compiler = self.compiler()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f".{so.stem}.{os.getpid()}.so")
            proc = subprocess.run(
                [compiler, *self.flags, "-o", str(tmp), str(self.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self.build_log = proc.stdout
            if proc.returncode != 0:
                raise RuntimeError(f"{compiler} failed to build "
                                   f"{self.source}:\n{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        self.bind(lib)
        self.path = so
        self._lib = lib
        return lib


def load_all(libraries: Sequence[Library]):
    """Build and load several libraries, their compilers started together
    (one compiler process per source, side by side)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return list(pool.map(Library.load, libraries))


COUNTERS = []  # every kernel's LaunchCounter, in order of definition


class LaunchCounter:
    """Launches of one kernel, counted by its wrapper where it launches."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        COUNTERS.append(self)


def reset_counts():
    """Set every kernel's launch count to 0."""
    for c in COUNTERS:
        c.launches = 0


def launch_counts() -> dict:
    return {c.name: c.launches for c in COUNTERS}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (132 on an H100
    SXM), which the kernels' grids are sized from."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(name: str, fn, device, args):
    """Call the C entry point `fn` on `device`'s current stream; raise on a
    refused launch (the entry point returns cudaGetLastError()). The device
    is made current for the call only where it is not already; the stream is
    passed as its raw handle."""
    import torch

    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
