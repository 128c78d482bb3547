"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` becomes one shared library with a plain C
interface, compiled for Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v \
         -o build/torch_kernels/lib<name>-<hash>.so <name>.cu

(ptxas's register / spill report lands in lib<name>-<hash>.log.)

The build happens at first use, into `build/torch_kernels/` at the repo
root, keyed by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is. `build_all()` starts one
nvcc per source at once. A failed build raises with nvcc's stderr.
Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("paged_attention", "paged_prefill", "flash_attention",
           "flash_attention_bwd", "svrg_update", "rglru_scan", "rwkv6_scan",
           "rglru_scan_bwd", "rwkv6_scan_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# dtype codes shared with csrc/common.cuh:rt::DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3, torch.float8_e4m3fn: 4}
# what the kernels are instantiated for: query / activation dtypes, the
# quantized pool dtypes (which come with float32 scale tables), and the
# attention kernels' head dims: every head dim a config or its .reduced()
# has (16 reduced, 64 smollm / rwkv6, 80 stablelm, 128, 256 recurrentgemma)
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
HEAD_DIMS = (16, 64, 80, 128, 256)
# csrc/paged_attention.cu: CHUNK, the tokens of a row each block of the
# split takes (a constant, so a row's bits never depend on the batch);
# csrc/flash_attention.cu: BN, the keys per tensor-core tile (also
# csrc/paged_prefill.cu's tensor-core kernel's)
PAGED_CHUNK = 128
FLASH_KEY_TILE = 64

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures of the extern "C" entry points (pointers and the stream as
# c_void_p so ctypes does not cut them to 32 bits)
SIGNATURES = {
    "paged_attention": [_P] * 10 + [_I] * 9 + [_F, _P],
    "paged_prefill": [_P] * 11 + [_I] * 10 + [_F, _P],
    "paged_prefill_wgmma": [_P] * 11 + [_I] * 11 + [_F, _P],
    # the flash entries end with prefix_len
    "flash_attention": [_P] * 4 + [_I] * 9 + [_F, _P, _I],
    "flash_attention_wgmma": [_P] * 5 + [_I] * 9 + [_F, _P, _I],
    "flash_attention_bwd": [_P] * 10 + [_I] * 9 + [_F, _P, _I],
    "flash_attention_bwd_wgmma": [_P] * 13 + [_I] * 9 + [_F, _P, _I],
    "svrg_update": [_P] * 6 + [_I, _L, _F, _F, _P],
    "rglru_scan": [_P] * 5 + [_I] * 5 + [_P],
    "rwkv6_scan": [_P] * 9 + [_I] * 5 + [_P],
    "rglru_scan_bwd": [_P] * 8 + [_I] * 4 + [_P],
    "rwkv6_scan_bwd": [_P] * 17 + [_I] * 5 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels are "
                           "built at first use on a machine with the CUDA "
                           "toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc writing to a temporary file; returns (proc, tmp)."""
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> None:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{stderr}{stdout}")
    # ptxas's per-kernel registers / shared memory / spills, kept beside
    # the library
    _lib_path(name).with_suffix(".log").write_text(stderr + stdout)
    os.replace(tmp, _lib_path(name))


def build_all(names: List[str] = KERNELS) -> Dict[str, Path]:
    """Build every kernel whose library is missing, one nvcc each, all
    started together. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _start(n) for n in names if not _lib_path(n).exists()}
    try:
        for n, (proc, tmp) in procs.items():
            _finish(n, proc, tmp)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {n: _lib_path(n) for n in names}


@functools.lru_cache(maxsize=None)
def load(name: str, symbol: str | None = None):
    """The C entry point `symbol` (default: `name`) of kernel `name`'s
    library, building the library first if needed, with its argument
    types declared."""
    path = build_all([name])[name]
    fn = getattr(ctypes.CDLL(str(path)), symbol or name)
    fn.argtypes = SIGNATURES[symbol or name]
    fn.restype = ctypes.c_int
    return fn


# TMA copies tiles from global addresses on a 16-byte boundary
TMA_ALIGN = 16


def tma_copies(*ptrs: int) -> tuple:
    """For inputs at device addresses `ptrs` that a kernel reads with TMA:
    which must first be copied into a fresh buffer (True: the address is
    not on a TMA_ALIGN-byte boundary, as a contiguous view at an element
    offset may not be). A function of the pointers alone, so the route is
    fixed before the launch."""
    return tuple(p % TMA_ALIGN != 0 for p in ptrs)


def tma_ready(*tensors) -> tuple:
    """The tensors, each as it is where `tma_copies` leaves it and else a
    fresh contiguous copy (a fresh allocation is aligned far past 16
    bytes). A
    copy holds the same values, so the kernel gives the bits of a call on
    aligned inputs; aligned inputs pass through untouched."""
    return tuple(t.clone(memory_format=torch.contiguous_format) if c else t
                 for t, c in zip(tensors,
                                 tma_copies(*(t.data_ptr() for t in tensors))))


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (a C null) for None."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would record this launch: grad mode is on and an
    input requires grad. A kernel launched through raw pointers into a
    fresh buffer returns an output with no grad_fn, so the gradient to
    its inputs would be cut without a word. Every CUDA wrapper calls this
    before it launches, except those whose autograd Function launches a
    backward kernel: flash_attention, rglru_scan and rwkv6_scan (which
    still refuses return_states under autograd). None entries are
    skipped; with grad mode off (no_grad, inference_mode) it checks
    nothing."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            f"torch.no_grad() or on inputs that do not require grad")


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err}")
