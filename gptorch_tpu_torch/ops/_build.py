"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The build
happens at first use, into ``build/gptorch_tpu_torch/`` beside the package,
under a file name keyed by a hash of the sources and flags, so a changed
source is rebuilt and an unchanged one is reused within a checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gptorch_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    "--split-compile=0",  # optimise the kernels of one source in parallel, on every core
)

_libraries: dict = {}
#: nvcc's output for each kernel built in this process (ptxas reports each
#: kernel's registers, shared memory and spills).
build_logs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _library_path(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile the kernels in ``names`` whose library is missing, starting
    one ``nvcc`` per source, all together; wait for all, then raise if any
    failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        jobs.append((name, proc, tmp, lib))
    failed = []
    for name, proc, tmp, lib in jobs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        build([name])
        lib = _libraries[name] = ctypes.CDLL(str(_library_path(name)[1]))
    return lib
