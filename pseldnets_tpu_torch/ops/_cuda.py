"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. At first use it is compiled
by ``nvcc`` for ``sm_90a`` into a shared library under
``pseldnets_tpu_torch/_build/`` (named by a hash of its source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header builds
anew) and loaded with ``ctypes``. Every C entry point
launches on the stream it is given and returns ``cudaGetLastError()``; a
non-zero code raises here. Nothing is built or imported when a module is
imported: the CPU tests import every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

ptr = ctypes.c_void_p
i32 = ctypes.c_int
f32 = ctypes.c_float


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in pseldnets_tpu_torch/csrc")


class CudaKernel:
    """One ``csrc`` source, its C entry points and its launch count.

    ``launches`` is incremented by the Python wrapper each time it launches
    the kernel on a CUDA tensor, and nowhere else.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC / source
        self.functions = dict(functions)
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        """Start nvcc for this source unless its library exists; returns the
        process (or None) and the temporary output path."""
        out = self.library_path()
        if out.exists():
            return None, None
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def _finish_build(self, proc, tmp) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{self.build_log}")
        os.replace(tmp, self.library_path())

    def lib(self):
        if self._lib is None:
            self._finish_build(*self._start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, name: str, *args) -> None:
        """Launch C entry ``name`` on the current stream (its last argument)."""
        lib = self.lib()
        rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.source.name}:{name} failed: CUDA error "
                               f"{rc} ({lib.pt_error_string(rc).decode()})")


def build_all(kernels: List[CudaKernel]) -> float:
    """Build every kernel's library, one nvcc per source, all started
    together; returns the wall seconds."""
    t0 = time.perf_counter()
    started = [(k, *k._start_build()) for k in kernels]
    for k, proc, tmp in started:
        k._finish_build(proc, tmp)
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` where given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
