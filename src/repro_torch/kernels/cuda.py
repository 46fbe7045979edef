"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one nvcc
process per source, all started together) and linked into one shared
library with a plain C interface, linked against the driver library
(``-lcuda``, for the TMA descriptors) and loaded with ``ctypes``.  ptxas's
report of each kernel's registers, shared memory and spills is kept beside
it (``ptxas_report``).  The library is
built at first use into ``build/repro_torch/<hash>/`` at the root of the
checkout, where ``<hash>`` covers the sources and the flags, so an edited
source rebuilds and an unchanged one loads in milliseconds.  Nothing here
runs at import time: the CPU tests import every module on machines that
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# B1's and B5's TMA descriptors come from the driver API
# (cuTensorMapEncodeTiled):
# link libcuda, through the toolkit's stub at build time
LINK_LIBS = ("-lcuda",)
# ptxas's report (registers, shared memory, spills per kernel), kept
# beside the library
PTXAS_LOG = "ptxas.log"
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# dynamic shared memory a block may opt into on Hopper
MAX_SMEM_BYTES = 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points: pointers and the stream as c_void_p, sizes as c_int
SIGNATURES = {
    "repro_matmul": [_P] * 4 + [_I] * 9 + [_P],
    "repro_matmul_f32out": [_P] * 4 + [_I] * 8 + [_P],
    "repro_grouped_matmul": [_P] * 4 + [_I] * 14 + [_P],
    "repro_quantized_matmul": [_P] * 5 + [_I] * 7 + [_P],
    "repro_decode_attention": [_P] * 8 + [_I] * 11 + [_P],
    "repro_decode_attention_int8": [_P] * 10 + [_I] * 11 + [_P],
    "repro_prefill_attention": [_P] * 7 + [_I] * 13 + [_P],
    "repro_prefill_attention_int8": [_P] * 9 + [_I] * 13 + [_P],
    "repro_flash_attention": [_P] * 5 + [_I] * 8 + [_P],
    "repro_flash_attention_wgmma": [_P] * 5 + [_I] * 7 + [_P],
    "repro_flash_attention_bwd": [_P] * 9 + [_I] * 8 + [_P],
    "repro_flash_attention_bwd_wgmma": [_P] * 10 + [_I] * 7 + [_P],
    "repro_wkv": [_P] * 6 + [_I] * 8 + [_P],
    "repro_wkv_mma": [_P] * 6 + [_I] * 7 + [_P],
    "repro_wkv_bwd": [_P] * 12 + [_I] * 5 + [_P],
    "repro_jacobi4": [_P] * 2 + [_I] * 3 + [_P],
    "repro_nbody": [_P] * 4 + [_I] * 3 + [_F, _P],
    # int32 values: no float dtype code
    "repro_histogram": [_P] * 2 + [_I] * 3 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_LIBS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "librepro_torch.so"


def build() -> Path:
    """Compile and link the library unless it is already built; returns
    its path.  Raises with nvcc's output when a source does not compile."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        jobs = []
        for cu in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (cu.stem + ".o")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((cu, obj, proc))
        failed, logs = [], []
        for cu, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"--- {cu.name}\n{out}")
            if proc.returncode:
                failed.append(logs[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        (so.parent / PTXAS_LOG).write_text("\n".join(logs))
        tmp_so = Path(tmp) / so.name
        stubs = Path(nvcc).resolve().parent.parent / "lib64" / "stubs"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *[str(o) for _, o, _ in jobs],
             f"-L{stubs}", *LINK_LIBS, "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_so, so)       # atomic: a concurrent loader never
    return so                        # sees a half-written library


def ptxas_report(kernel_substring: str) -> list:
    """ptxas's lines (registers, shared memory, spills) for the kernels
    whose mangled names contain ``kernel_substring``, from the last build
    of the current sources."""
    log = library_path().parent / PTXAS_LOG
    if not log.exists():
        return []
    lines, keep = log.read_text().splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel_substring in line:
            keep.append(line.split("'")[1] if "'" in line else line)
            keep += [ln.strip() for ln in lines[i + 1:i + 4]
                     if "ptxas info" in ln or "bytes stack frame" in ln]
    return keep


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def c_ints(name: str, *values: int) -> tuple:
    """Sizes and strides for a C ``int`` argument; raises on overflow
    (ctypes would silently truncate them)."""
    for v in values:
        if not 0 <= v < 2 ** 31:
            raise ValueError(f"{name}: size or stride {v} does not fit a C int")
    return values


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t from a C entry point: a launch the
    runtime refused never runs, and no later synchronize reports it."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def require_cuda(name: str, *tensors: torch.Tensor,
                 contiguous: bool = True) -> None:
    """Every tensor on one CUDA device (and contiguous, by default)."""
    for t in tensors:
        if not t.is_cuda or t.device != tensors[0].device:
            raise ValueError(f"{name}: every input must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
