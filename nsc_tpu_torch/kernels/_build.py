"""Build the CUDA sources under `nsc_tpu_torch/csrc` into one shared
library with a plain C interface, and load it with ctypes.

Each source is compiled by its own `nvcc` process, all started together,
then the objects are linked into `libnsc_kernels.so` under
`nsc_tpu_torch/_build/<hash of sources and flags>/`. A build happens on the
first call of `library()` in a process, never on import; a library already
built from the same sources is reused. There is no fallback: without `nvcc`
the call raises, and a build that failed raises again on every later call
in the process without compiling anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("residual_stack.cu", "rvq.cu", "stft.cu", "residual_stack_cl.cu", "fused_stage.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libnsc_kernels.so"

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
# C entry points: name -> argument types. Every pointer and the stream are
# void*; every one returns the cudaError_t of its launch (0 = success).
SIGNATURES = {
    # x, out, w1, b1, a1, w2, b2, a2, dilations(host int*), B, C, T, U,
    # is_bf16, fast_act, stream
    "nsc_residual_stack": [_P] * 9 + [_I] * 6 + [_P],
    # z, planes, cb, csq, scratch (or null), idx, best (or null), M, n_q, K,
    # D, Kp, Dp, scratch blocks, stream
    "nsc_rvq_quantize": [_P] * 7 + [_I] * 7 + [_P],
    # cb, planes, n_q, K, D, Kp, Dp, stream
    "nsc_rvq_split_planes": [_P] * 2 + [_I] * 5 + [_P],
    # M, Dp, plan (6 long long: tiles, grid, blocks per SM, SMs, bytes,
    # streamed)
    "nsc_rvq_quantize_plan": [_I] * 2 + [_P],
    # idx, cb, out, M, n_q, K, D, stream (also the earlier design, `_rowwarp`,
    # which only chip_smoke.py times)
    "nsc_rvq_dequantize": [_P] * 3 + [_I] * 4 + [_P],
    "nsc_rvq_dequantize_rowwarp": [_P] * 3 + [_I] * 4 + [_P],
    # x, win, tw, order (the load's int32 positions), out, re, im (or null),
    # B, T, n_fft, hop, F, the pass list (4 bits a radix), stream
    "nsc_stft_magnitude_fft": [_P] * 7 + [_I] * 5 + [_U64, _P],
    # n_fft, hop, plan (2 long long: frames per block, bytes)
    "nsc_stft_fft_plan": [_I] * 2 + [_P],
    # x, win, chirp, twm, fb, out, re, im (or null), B, T, n_fft, hop, F, M,
    # the pass list of M, stream
    "nsc_stft_magnitude_bluestein": [_P] * 8 + [_I] * 6 + [_U64, _P],
    # M, plan (2 long long: frames per block, bytes)
    "nsc_stft_bluestein_plan": [_I] + [_P],
    # x, win, chirp, twm, fb, out, re, im (or null), B, T, n_fft, hop, F, M,
    # C (the blocks of a cluster), the pass list of M, stream
    "nsc_stft_magnitude_bluestein_cluster": [_P] * 8 + [_I] * 7 + [_U64, _P],
    # M, C, plan (3 long long: threads a block, bytes a block, clusters the
    # card holds at once)
    "nsc_stft_bluestein_cluster_plan": [_I] * 2 + [_P],
    # x, win, chirp, twm, fb, scratch, out, re, im (or null), B, T, n_fft,
    # hop, F, M, C (the shares), chunk (the transforms the scratch holds),
    # the pass list of M, stream
    "nsc_stft_magnitude_bluestein_global": [_P] * 9 + [_I] * 8 + [_U64, _P],
    # M, C, plan (4 long long: threads a block, offsets a tile, bytes a
    # share block, bytes a tile block)
    "nsc_stft_bluestein_global_plan": [_I] * 2 + [_P],
    # x, out, w1, b1, a1, w2, b2, a2, w1p, w2p (bf16 planes or null),
    # dilations, B, C, T, U, is_bf16, fast, stream; x and out (B, T, C),
    # float32 weights
    "nsc_residual_stack_cl": [_P] * 11 + [_I] * 6 + [_P],
    # x, out, hw, hb, ha, w1, b1, a1, w2, b2, a2, w1p, w2p, ta, tw, tb,
    # dilations, B, Cin, Cmid, Cout, Tin, U, s_head, s_tail, is_bf16, fast,
    # stream
    "nsc_fused_stage": [_P] * 17 + [_I] * 10 + [_P],
    # C, halo, is_bf16, fast, planes, plan (2 long long: tile, bytes)
    "nsc_stack_plan": [_I] * 5 + [_P],
    # Cin, Cmid, Cout, s_head, s_tail, units' halo, is_bf16, fast, plan
    "nsc_fused_stage_plan": [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib = None
_error = None         # the failure of this process's build, if it failed
build_seconds = None  # wall time of this process's build (0.0 if reused)
build_log = ""        # nvcc's messages, including ptxas register/smem use


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    global build_log
    exe = nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / (Path(src).stem + ".o")
            cmd = [exe, *FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs = []
        for src, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src}\n{text}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        lib = tmp / LIB_NAME
        link = subprocess.run(
            [exe, *ARCH, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        build_log = "\n".join(logs)
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib, out)  # atomic: a concurrent build never sees half a file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, _error, build_seconds
    with _lock:
        if _error is not None:
            raise RuntimeError("the kernel library failed to build earlier in this process") from _error
        if _lib is None:
            t0 = time.perf_counter()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            out = BUILD_DIR / _digest() / LIB_NAME
            if not out.exists():
                try:
                    _compile(out)
                except Exception as e:
                    _error = e
                    raise
            lib = ctypes.CDLL(str(out))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nsc_error_string.argtypes = [_I]
            lib.nsc_error_string.restype = ctypes.c_char_p
            build_seconds = time.perf_counter() - t0
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        what = _lib.nsc_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {what}")
