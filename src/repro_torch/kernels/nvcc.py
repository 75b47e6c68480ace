"""Build a CUDA source into a shared library with a plain C interface and
open it with ctypes — the build route of every kernel of the port.

``NvccLibrary(name, source, functions)`` compiles ``source`` with
``nvcc`` (``kernels/csrc`` on the include path) into
``build/torch_ext/<name>-<digest>.so`` at the root of the checkout.
The digest covers the source, the shared headers and the flags, so an
unchanged library is built once per checkout.  ``start()`` launches
nvcc in the background, so several libraries build at once;
``load()`` waits for the build and opens the library with the argument
types of ``functions``.  Nothing is built when a module is imported.

A kernel that cannot be built (no toolkit, an nvcc error) or whose
launch returns a CUDA error raises ``KernelError``: callers that turn
other exceptions into per-request failures (the clustering serve
engine) let this one through to their caller.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"
_NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
               "-shared", "-Xcompiler", "-fPIC"]

# ctypes argument codes of the C interfaces
PTR, I32, I64, F64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                      ctypes.c_double)


class KernelError(RuntimeError):
    """A kernel of the port failed to build or to launch."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH); the CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class NvccLibrary:
    """One kernel source, built on first use and opened with ctypes."""

    def __init__(self, name: str, source: Path,
                 functions: Dict[str, Tuple[object, Sequence[object]]]):
        self.name = name
        self.source = Path(source)
        self.functions = functions          # C name -> (restype, argtypes)
        self._proc: Optional[subprocess.Popen] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        h = hashlib.sha1(" ".join(_NVCC_FLAGS).encode())
        for f in [self.source] + sorted(SHARED_CSRC.glob("*.cuh")):
            h.update(f.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start(self) -> None:
        """Launch nvcc in the background unless the library is built or
        building."""
        with self._lock:
            if self._lib is not None or self._proc is not None:
                return
            out = self.path
            if out.exists():
                return
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            self._proc = subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, f"-I{SHARED_CSRC}", "-o", str(tmp),
                 str(self.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self._tmp = tmp

    def load(self) -> ctypes.CDLL:
        """Wait for the build (starting it if need be) and open the
        library; raises with nvcc's output if the build failed."""
        if self._lib is not None:
            return self._lib
        self.start()
        with self._lock:
            if self._lib is not None:
                return self._lib
            out = self.path
            if self._proc is not None:
                log, _ = self._proc.communicate()
                if self._proc.returncode != 0:
                    self._proc = None
                    raise KernelError(f"nvcc failed to build {self.source}:"
                                       f"\n{log}")
                os.replace(self._tmp, out)
                self._proc = None
            lib = ctypes.CDLL(str(out))
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            for fn, (restype, argtypes) in self.functions.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            self._lib = lib
            return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code; every
    library exports ``const char* error_string(int)``."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise KernelError(f"{what}: CUDA error {code} ({msg})")
