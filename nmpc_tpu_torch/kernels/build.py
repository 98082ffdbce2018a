"""Build the CUDA sources of ``nmpc_tpu_torch/csrc/`` at first use.

Each translation unit is compiled by ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` by its wrapper.  A unit is a
short generated text that includes the templates of ``csrc/`` and
instantiates one kernel for one shape and dtype, or for one problem's
traced callables (:func:`build_generated`).  The library lands in
``build/nmpc_tpu_torch/``
at the root of the checkout, under a name that carries a hash of the
unit's text, of every ``csrc/`` header it includes (followed through the
headers' own includes) and of the flags: an edited source or header is
rebuilt, an unchanged one reused.  ``nvcc``'s ``-Xptxas -v`` report
(registers, spills) is kept beside the library, under its name with
``.log`` for ``.so``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nmpc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


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


def included_headers(text: str, csrc: Path = CSRC) -> list[Path]:
    """The ``csrc`` headers ``text`` includes with ``#include "..."``,
    directly or through other headers, each once, in a fixed order."""
    found, todo = [], list(_INCLUDE.findall(text))
    while todo:
        path = csrc / todo.pop(0)
        if path in found or not path.exists():
            continue
        found.append(path)
        todo.extend(_INCLUDE.findall(path.read_text()))
    return found


def library_path(name: str, text: str, csrc: Path = CSRC,
                 flags: tuple = ()) -> Path:
    """Where the library of unit ``name`` with source ``text`` is built: the
    name carries a hash of the text, its included headers and the flags
    (``NVCC_FLAGS`` plus the unit's own ``flags``)."""
    h = hashlib.sha256(text.encode())
    for header in included_headers(text, csrc):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_generated(name: str, text: str, flags: tuple = (),
                    csrc: Path = CSRC) -> Path:
    """Compile a generated unit (``text`` may include the headers under
    ``csrc``, this checkout's ``csrc/`` unless another is named) with
    nvcc's ``NVCC_FLAGS`` and ``flags`` unless an up-to-date library
    exists; the source is written beside the library.  Raises
    ``RuntimeError`` with nvcc's output on failure."""
    lib = library_path(name, text, csrc, flags)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = lib.with_suffix(".cu")
    tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, src)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, *flags, f"-I{csrc}", "-o", str(tmp),
         str(src)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def load(path: Path) -> ctypes.CDLL:
    """The loaded library at ``path`` (once per process)."""
    return ctypes.CDLL(str(path))
