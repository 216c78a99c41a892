"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface, which is loaded with :mod:`ctypes`. Nothing here includes
PyTorch's headers, so a build takes seconds. The library is built on first
use into ``repro_torch/_build/<hash>/``, keyed by a hash of the sources
and flags, and reused while they are unchanged. A missing ``nvcc`` or a
failed build raises: there is no fallback.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises when that is not 0 and
counts the launches that succeeded.

A cache hit reads back what ``ptxas`` reported when the library was
built, so the registers and spills of each kernel are known either way.

The library links the CUDA runtime only, no ``-lcuda``: the one driver
call the kernels need, ``cuTensorMapEncodeTiled`` (TMA tensor maps of the
flash kernel), is fetched at run time with ``cudaGetDriverEntryPoint``.
Headers under ``csrc/`` (``*.cuh``) are part of the hash, so a change to
one rebuilds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"
PTXAS_LOG = "ptxas.txt"     # beside the library: what the build reported


@dataclass
class BuildInfo:
    """What the last build (or cache hit) of the library reported."""

    path: Path
    cached: bool
    seconds: float
    ptxas: List[str] = field(default_factory=list)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build repro_torch's kernels")
    return nvcc


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags and of every file under ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: List[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, check=False)


def _compile(nvcc: str, sources: Sequence[Path], out_dir: Path
             ) -> List[str]:
    """Compile every source in parallel, then link; returns ptxas lines."""
    objs = [out_dir / (s.stem + ".o") for s in sources]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(s), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, o in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    link = _run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                 str(out_dir / LIB_NAME), *map(str, objs)])
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    return [ln.strip() for log in logs for ln in log.splitlines()
            if re.search(r"ptxas info\s*:\s*(Compiling|Used)|spill stores",
                         ln)]


def build() -> BuildInfo:
    """Build the library if its sources changed; return what it took."""
    global _info
    with _lock:
        if _info is not None:
            return _info
        sources = _sources()
        out_dir = BUILD_ROOT / _digest()
        lib_path = out_dir / LIB_NAME
        if lib_path.exists():
            log = out_dir / PTXAS_LOG
            _info = BuildInfo(lib_path, cached=True, seconds=0.0,
                              ptxas=log.read_text().splitlines()
                              if log.exists() else [])
            return _info
        nvcc = find_nvcc()
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_ROOT / f".tmp-{os.getpid()}-{threading.get_ident()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        t0 = time.perf_counter()
        try:
            ptxas = _compile(nvcc, sources, tmp)
            (tmp / PTXAS_LOG).write_text("\n".join(ptxas))
            # Another process may have finished the same build meanwhile;
            # either copy is the same library.
            try:
                tmp.rename(out_dir)
            except OSError:
                if not lib_path.exists():
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _info = BuildInfo(lib_path, cached=False,
                          seconds=time.perf_counter() - t0, ptxas=ptxas)
        return _info


def library() -> ctypes.CDLL:
    global _lib
    info = build()
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(info.path))
        return _lib


class Kernel:
    """One C entry point of the library, with its count of launches.

    ``launches`` is a plain integer, raised by one for each launch that the
    CUDA runtime accepted; :func:`reset_launches` sets it back to 0.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1


KERNELS: List[Kernel] = []


def register_kernel(name: str, symbol: str, argtypes: Sequence) -> Kernel:
    k = Kernel(name, symbol, argtypes)
    KERNELS.append(k)
    return k


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Checks the wrappers make before they hand pointers to a kernel.
# ---------------------------------------------------------------------------
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  ndim: int, dtype: Optional[torch.dtype] = None,
                  aligned: bool = True) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``ndim`` dims on
    ``device`` (and of ``dtype`` when given), 16-byte aligned unless
    ``aligned`` is False (a kernel with a routine for any alignment)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def on_card(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (the plain version serves it), True for a
    CUDA tensor (the kernel serves it, or the call raises)."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: unsupported device {t.device}")


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel that has no backward: its
    output, written through a raw pointer, would carry no gradient."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel: call it under torch.no_grad() "
            "or on inputs that do not require grad")
