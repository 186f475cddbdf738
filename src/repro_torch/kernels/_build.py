"""Builds the CUDA sources in ``csrc/`` at first use and loads them.

Each ``csrc/*.cu`` file becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into
``<repo>/build/repro_torch_kernels/`` and loaded with ``ctypes``.  All
sources compile in parallel (one ``nvcc`` per file).  A library's file name
carries the hash of its source and flags, so an edited source rebuilds and
an unchanged one loads from disk.

Flags: ``-O3 --fmad=false`` and no fast math, so the ABFP epilogue keeps
the reference's float32 operation order.

Each C entry point returns ``cudaGetLastError()``; ``check`` raises when it
is not 0.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# The C signatures, by source: entry point -> ctypes argument types.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, list]] = {
    "abfp_matmul": {
        "abfp_matmul_packed_launch": (
            [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I]   # x .. Ntot
            + [_I] * 9 + [_P] + [_I] * 3                    # nseg .. nk
            + [_F, _F, _I, _F, _F, _F, _F]                  # adc .. lx
            + [_I]                                          # rows (route)
            + [_P] * 5),                                    # buffers, stream
        "abfp_quantize_w_launch": [_P] + [_I] * 6 + [_F] + [_P] * 3,
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 4 + [_I] * 7 + [_F, _I, _I, _P],
    },
    "decode_attention": {
        "decode_attention_launch": (
            [_P, _I, _P, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_F, _P]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{h}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel, then load them all."""
    with _LOCK:
        if len(_LIBS) == len(SIGNATURES):
            return _LIBS
        _BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SIGNATURES:
            out = lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT), tmp, out)
        errors = []
        for name, (p, tmp, out) in procs.items():
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"{name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for name, sigs in SIGNATURES.items():
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in sigs.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """The current PyTorch CUDA stream of ``device`` as an integer handle."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
