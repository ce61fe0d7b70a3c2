"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>_<hash>.so`` at the repository root (git-ignored),
at first use. The hash covers the source and the flags, so an edited source
is rebuilt. Nothing here runs at import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = ("fused_attention",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get(
        "CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def nvcc_command(name: str, output: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(output),
            str(CSRC_DIR / f"{name}.cu")]


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing.

    Returns {name: compiler output} for the sources compiled in this call
    (ptxas reports registers, shared memory and spills per kernel). Raises
    with the compiler output if a compile fails. Each build writes a file of
    its own and renames it into place, so concurrent builds do not collide.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {}
    for name in names:
        output = library_path(name)
        if output.exists():
            continue
        tmp = output.with_name(f"{output.name}.{os.getpid()}.tmp")
        proc = subprocess.run(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs[name] = proc.stdout
        (BUILD_DIR / f"{name}.log").write_text(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
        os.replace(tmp, output)
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
