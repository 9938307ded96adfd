"""Build and load the port's native code.

Each ``csrc/*.cu`` file (the kernels ``fused_path``, ``intersect``,
``bvh_traverse``, ``bvh_binary``, ``kexp_traverse`` and ``smem_probe``) is
compiled by ``nvcc`` into a shared library with a plain C interface, loaded
with ``ctypes``; ``csrc/*.cpp`` files (host code: the BVH builder) go
through ``g++`` the same way. A library goes to ``build/kernels/`` at the
root of the checkout, named by a hash of its source, the headers beside it
and the flags, so an edit rebuilds it and an unchanged source is reused.
Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
KERNELS = ("fused_path", "intersect", "bvh_traverse", "bvh_binary",
           "kexp_traverse", "smem_probe")


class CompilerNotFound(RuntimeError):
    """This machine has no compiler for the source (as against a compile
    that failed)."""


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise CompilerNotFound("nvcc not found: the CUDA kernels need the "
                               "CUDA toolkit (CUDA_HOME or nvcc on PATH)")
    return found


def _compile(src: Path, compiler: str, flags) -> ctypes.CDLL:
    """Compile ``src`` if its library is not there yet, and load it. Sets
    ``load.build_seconds[name]`` to the compile time (0 if reused)."""
    name = src.stem
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed on {src.name}:"
                               f"\n{proc.stderr}")
        load.ptxas_log[name] = proc.stderr
        os.replace(tmp, so)
    load.build_seconds[name] = time.perf_counter() - t0
    return ctypes.CDLL(str(so))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of the CUDA kernel ``csrc/<name>.cu``, built by nvcc."""
    return _compile(CSRC / f"{name}.cu", _nvcc(), NVCC_FLAGS)


load.build_seconds = {}
load.ptxas_log = {}


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The library of the host source ``csrc/<name>.cpp``, built by g++
    (no CUDA toolkit needed). Raises CompilerNotFound when there is no
    g++, RuntimeError when the compile fails."""
    gxx = shutil.which("g++")
    if not gxx:
        raise CompilerNotFound("g++ not found: the native BVH builder needs "
                               "a host C++ compiler")
    return _compile(CSRC / f"{name}.cpp", gxx, HOST_FLAGS)


def load_all(names=KERNELS, host=("bvh_builder",)) -> None:
    """Build several libraries at once: one compiler process per source,
    all started together (each load waits on its own compiler in its own
    thread)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names) + len(host)) as pool:
        futs = [pool.submit(load, n) for n in names]
        futs += [pool.submit(load_host, n) for n in host]
        for fut in futs:
            fut.result()
