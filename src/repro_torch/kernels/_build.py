"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
and loaded with :mod:`ctypes`.  The library's name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.  No PyTorch header is compiled: that keeps a build to seconds.

Nothing here runs at import time; the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures per source: every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints and cut them.
SIGNATURES = {
    "quant_matmul.cu": {
        # x, M, Kx, Kp, packed, table, scales, T, tile_n, out, stream
        "qmm_fused_f32": [_P, _LL, _I, _I, _P, _P, _P, _I, _I, _P, _P],
        # x, M, Kx, K, packed, N, scale, bits, E, out, stream
        "qmm_pergroup_f32": [_P, _LL, _I, _I, _P, _I, _P, _I, _I, _P, _P],
        # x, M, Kx, Kp, packed, expert_bytes, table, scales, T, tile_n, E,
        # round_bf16, out, stream
        "qmm_fused_experts_f32": [_P, _LL, _I, _I, _P, _LL, _P, _P, _I, _I, _I, _I, _P, _P],
        # x, M, Kx, K, packed, N, scale, bits, E, mf, wk, wn, out, stream
        "qmm_pergroup_mma": [_P, _LL, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
        # x, M, Kx, Kp, packed, expert_bytes, table, scales, T, tile_n, E, dq,
        # mf, wk, wn, out, stream
        "qmm_fused_mma": [_P, _LL, _I, _I, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P],
    },
    "int8_matmul.cu": {
        # a, b, sa, sb, M, N, K, kind, nf, wm, wn, grid_m, tiles_n, splits, kper,
        # ws, counters, out, stream
        "i8mm_tc": [_P, _P, _P, _P, _LL, _I, _LL, _I, _I, _I, _I, _LL, _I, _I, _LL,
                    _P, _P, _P, _P],
    },
    "decode_attention.cu": {
        # q, q_bf16, k_packed, k_scales, v_packed, v_scales, pos, scratch, part,
        # out, out_bf16, B, KV, rep, hd, S, NB, G, bits[4], sizes[4], sqrt_hd, P,
        # stream
        "decode_attention_f32acc": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I]
                                   + [_I] * 15 + [_F, _I, _P],
    },
    "fake_quant.cu": {
        # w, w_bf16, gamma, alpha, N, K, nb, b0, b1, b2, out, stream
        "fused_mix_f32": [_P, _I, _P, _P, _LL, _LL, _I, _I, _I, _I, _P, _P],
    },
}

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _library_path(source: str) -> Path:
    digest = hashlib.sha1((CSRC / source).read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(sources=tuple(SIGNATURES)) -> dict:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns ``{source: ptxas log}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _nvcc(), {}
    for src in sources:
        so = _library_path(src)
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[src] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, so)
    for src, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {CSRC / src}:\n{log}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)          # atomic: concurrent builds agree
    return {src: _library_path(src).with_suffix(".log").read_text()
            for src in sources}


def check_cuda(name: str, tensors: dict, dtypes: dict) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype:
    a kernel reads raw pointers and would read the wrong bytes."""
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected cuda")
        if t.dtype != dtypes[key]:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtypes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def raise_on(rc: int, name: str) -> None:
    """Raise on a launch's ``cudaGetLastError()`` (a refused launch never
    runs, and no synchronize reports it)."""
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build_all((source,))
        lib = ctypes.CDLL(str(_library_path(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib
