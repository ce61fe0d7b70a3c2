"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>_<hash>.so`` at the repository root (git-ignored),
at first use. The hash covers the source, the sources it includes
(``INCLUDES``), the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt. Nothing here runs at import time.
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
SOURCES = ("fused_attention", "short_attention_fwd", "short_attention_bwd",
           "flash_attention", "flash_attention_fwd", "flash_keybias_bwd",
           "flash_relpos_bwd", "layer_norm", "attn_block")
# K8 compiles K1's device code into its own library
INCLUDES = {"attn_block": ("fused_attention", "short_attention_fwd",
                           "short_attention_bwd")}
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
    source = b"".join((CSRC_DIR / f"{n}.cu").read_bytes()
                      for n in (name, *INCLUDES.get(name, ())))
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def nvcc_command(name: str, output: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(output),
            str(CSRC_DIR / f"{name}.cu")]


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, all at once
    (one ``nvcc`` process per source, started together).

    Returns {name: compiler output} for the sources compiled in this call
    (ptxas reports registers, shared memory and spills per kernel). Raises
    with the compiler output if a compile fails. Each build writes a file of
    its own and renames it into place, so concurrent builds do not collide.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        output = library_path(name)
        if output.exists():
            continue
        tmp = output.with_name(f"{output.name}.{os.getpid()}.tmp")
        running[name] = (output, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (output, tmp, proc) in running.items():
        logs[name] = proc.communicate()[0]
        (BUILD_DIR / f"{name}.log").write_text(logs[name])
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, output)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
