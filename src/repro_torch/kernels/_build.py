"""Build and load a hand-written CUDA kernel library.

Each kernel's CUDA sources (``csrc/*.cu``) are compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` at the repository root, the first time a CUDA tensor
reaches the kernel.  The library's name carries a hash of the sources and
flags, so an edit rebuilds it.  It is loaded with ``ctypes``: the kernel's
module declares ``argtypes`` and ``restype`` of every function it calls
(``c_void_p`` for each pointer and the stream).  Nothing here runs at import
time, so the CPU tests import the kernel modules on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from csrc/ with the CUDA toolkit's nvcc")
    return found


class CudaLibrary:
    """One kernel's shared library: ``name`` prefixes the file, ``sources``
    lie in ``csrc``, and ``declare(lib)`` sets the ctypes signatures."""

    def __init__(self, name: str, csrc: Path, sources: Sequence[str],
                 declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.csrc = csrc
        self.sources = tuple(sources)
        self.declare = declare
        self.build_log = ""        # nvcc's output (ptxas register report)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        """Where the library for the current sources and flags lives."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources:
            h.update((self.csrc / src).read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the sources unless this exact build exists; returns its
        path.  The library is written under a temporary name and renamed
        into place, so concurrent builders never load a half-written file."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(self.csrc / s) for s in self.sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.name} with code "
                               f"{proc.returncode}:\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self.declare(lib)
                self._lib = lib
        return self._lib
