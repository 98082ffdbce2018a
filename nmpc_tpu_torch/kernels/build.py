"""Build the CUDA sources under ``nmpc_tpu_torch/csrc/`` at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` by its wrapper.  The library lands in
``build/nmpc_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  ``nvcc``'s ``-Xptxas -v`` report
(registers, spills) is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nmpc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise FileNotFoundError(
            f"nvcc not found on PATH nor at {path}; the CUDA kernels need "
            "the CUDA toolkit")
    return str(path)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    return the library's path.  Raises ``RuntimeError`` with nvcc's output
    if the compile fails."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib
