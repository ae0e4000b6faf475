"""Build-at-first-use of the port's native sources into ``_build/``.

Each shared library is compiled from the package's own sources into
``d2slam_tpu_torch/_build/`` (ignored by git), under a name that carries
a hash of the source and the command, so an edited source is rebuilt
and a stale library is never loaded. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``) when it exists, else ``nvcc`` from the PATH."""
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build_shared_lib(name: str, src: str, compiler: list, flags: list,
                     libs: list = ()) -> ctypes.CDLL:
    """Compile ``src`` (a path inside the package) with
    ``compiler + flags + ["-o", out, src] + libs`` unless a library built from
    the same source and command exists, then load it. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(compiler + flags + list(libs)).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(compiler + flags + ["-o", tmp, src] + list(libs),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {os.path.basename(src)} failed:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builders agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(out)
