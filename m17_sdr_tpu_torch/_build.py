"""Build, load and dispatch to the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Libraries go
to ``build/`` at the repository root under a name keyed by a hash of
the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built at import: the first launch
builds its kernel, and ``build_all`` builds every kernel in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contraction of a*b+c into an FMA anywhere in the kernels: they
    # must round exactly as their plain PyTorch versions do
    "--fmad=false",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


class CudaKernel:
    """One kernel source, its exported C entry point and a launch count.

    The entry point returns ``cudaGetLastError()`` after the launch;
    ``launch`` raises if it is not 0 and otherwise adds one to
    ``launches``.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _start_build(self) -> tuple[subprocess.Popen, Path] | None:
        if self.lib_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish_build(self, started: tuple[subprocess.Popen, Path] | None) -> None:
        if started is None:
            return
        proc, tmp = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{self.build_log}")
        os.replace(tmp, self.lib_path)    # atomic: concurrent builds agree

    def _entry(self):
        if self._fn is None:
            self._finish_build(self._start_build())
            fn = getattr(ctypes.CDLL(str(self.lib_path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self._entry()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# (soft [N, 2T] f32, bits [N, T] u8, metric [N] f32, n, t, stream)
VITERBI = CudaKernel("viterbi.cu", "m17_viterbi_decode", [_P, _P, _P, _I, _I, _P])

# (samples [B, S2] f32 and window [B, 31] f32, each with its two element
#  strides, taps [2, 40, 31] f32, pats [6, 8] f32 in host memory, 14 state
#  pointers in, 14 state pointers out, window out [B, 31] f32, slot [B, S2]
#  f32, flags [B, S2] i32, b, s2, stream) -- see csrc/receiver_scan.cu
RECEIVER_SCAN = CudaKernel("receiver_scan.cu", "m17_receiver_scan",
                           [_P, _L, _L, _P, _L, _L, _P, _P] + [_P] * 14 + [_P] * 14
                           + [_P, _P, _P, _I, _I, _P])

KERNELS = (VITERBI, RECEIVER_SCAN)


def build_all() -> None:
    """Build every kernel not built yet, one nvcc each, all at once."""
    procs = [(k, k._start_build()) for k in KERNELS]
    errors = []
    for k, proc in procs:        # wait for every nvcc before raising
        try:
            k._finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def use_kernel_for(x: torch.Tensor, use_kernel: bool | None) -> bool:
    """None: the kernel exactly when ``x`` lies on CUDA.  False: the plain
    version, on any device.  True: the kernel; a CPU tensor raises."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("the CUDA kernels need CUDA tensors")
    return bool(use_kernel)


def check_cuda_input(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int,
                     contiguous: bool = True) -> None:
    """What every kernel wrapper requires of an input tensor."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
