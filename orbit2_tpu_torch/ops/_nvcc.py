"""Build a CUDA source under ``csrc/`` with nvcc at first use and load it.

Each source is a plain C interface compiled into its own shared library and
bound with ctypes. The library is named after a hash of the source and of
every csrc/ header it includes, so an edited source or header is rebuilt and
a stale library is never loaded. Nothing here
runs at import time: the CPU-only test runs import every module.
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
from typing import List

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


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

    def sources(self) -> List[Path]:
        """The source and every csrc/ header it includes, directly or not."""
        seen: List[Path] = []
        todo = [self.source]
        while todo:
            path = todo.pop()
            if path in seen:
                continue
            seen.append(path)
            for name in _INCLUDE.findall(path.read_text()):
                if (CSRC_DIR / name).is_file():
                    todo.append(CSRC_DIR / name)
        return seen

    def path(self) -> Path:
        h = hashlib.sha256()
        for src in self.sources():
            h.update(src.name.encode() + b"\0" + src.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:12]}.so"

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


class NvccKernel:
    """One entry point of an NvccLibrary and the count of its launches.

    The entry point takes `argtypes` followed by the CUDA stream, and
    returns 0, a cudaError_t code, -1 for an instance it does not have or
    -2 for a TMA tensor map the driver refuses;
    `launch` raises on anything but 0 and counts the launches that ran."""

    def __init__(self, library: NvccLibrary, symbol: str, argtypes):
        self.library = library
        self.name = symbol
        self.launches = 0
        self._argtypes = list(argtypes) + [ctypes.c_void_p]
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = self.library.load()
            fn = getattr(lib, self.name)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            lib.orbit2_cuda_error_string.argtypes = [ctypes.c_int]
            lib.orbit2_cuda_error_string.restype = ctypes.c_char_p
            self._errstr = lib.orbit2_cuda_error_string
            self._fn = fn
        return self._fn

    def launch(self, device, *args) -> None:
        """Calls the entry point on `device`'s current stream."""
        fn = self._entry()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            msg = ({-1: "no kernel instance", -2: "tensor map refused by the driver"}.get(err)
                   or self._errstr(err).decode())
            raise RuntimeError(f"{self.name} launch failed ({err}): {msg}")
        self.launches += 1
