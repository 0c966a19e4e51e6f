"""Build a CUDA source under ``csrc/`` with nvcc at first use and load it.

Each source is a plain C interface compiled into its own shared library and
bound with ctypes. The library is named after a hash of the source, so an
edited source is rebuilt and a stale library is never loaded. Nothing here
runs at import time: the CPU-only test runs import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


class NvccLibrary:
    """One ``csrc/<source>`` compiled for sm_90a into ``_build/``.

    ``load()`` builds on first call and returns the ctypes handle;
    ``build_seconds`` is the compile time of this process's build (0.0 when
    an up-to-date library was already on disk)."""

    def __init__(self, source: str):
        self.source = CSRC_DIR / source
        self.build_seconds = 0.0
        self._lib = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            out = self.path()
            if not out.exists():
                self._build(out)
            self._lib = ctypes.CDLL(str(out))
        return self._lib

    def _build(self, out: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) for {self.source.name}:\n"
                f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
        self.build_seconds = time.perf_counter() - t0
