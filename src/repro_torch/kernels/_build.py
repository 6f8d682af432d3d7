"""Build and bind the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, land in
``build/kernels/`` at the repository root, and are keyed by a digest of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source rebuilds. ``build()`` starts one ``nvcc`` per source, all at once.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3`` and no
``--use_fast_math``, so the kernels use the same ``logf`` / ``log2f`` /
``expf`` as the plain PyTorch versions on the card. ``-Xptxas -v`` keeps
each kernel's register, shared-memory and spill report beside the library.

Nothing here falls back: without ``nvcc`` or on a failed build it raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    """One compiled source: its library, build time and ptxas report."""

    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    ptxas: str


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))
    )
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict[str, Built]:
    """Compile the named sources (default: all) in parallel; -> {name: Built}.

    Sources whose library already exists are not rebuilt. Raises with the
    compiler's output if any build fails.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running = []
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.exists():
            out[name] = Built(name, target, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, target, tmp, log, proc, time.perf_counter()))
    failed = []
    for name, target, tmp, log, proc, t0 in running:
        report, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{report}")
            continue
        log.write_text(report)
        os.replace(tmp, target)
        out[name] = Built(name, target, seconds, report)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


_LIBS: dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LIBS[name] = lib
    return lib


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    Calling it passes the arguments and PyTorch's current CUDA stream to
    the entry point, which launches the kernel asynchronously and returns
    ``cudaGetLastError()``; a nonzero code raises. ``launches`` counts the
    launches that went through, and nothing else adds to it.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        lib = library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{self.source}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        self._fn, self._err_str = fn, err_str

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            msg = self._err_str(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: cudaError {err} ({msg})")
        self.launches += 1


P = ctypes.c_void_p  # pointer argument (tensor.data_ptr())
I = ctypes.c_int
U = ctypes.c_uint
LL = ctypes.c_longlong
