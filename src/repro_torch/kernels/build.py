"""Build and load the hand-written CUDA kernels (route (b): nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles on its own into
``build/kernels/lib<name>-<digest>.so`` at the repository root, with a plain C
interface that ``ctypes`` binds: pointers and the stream as ``c_void_p``,
sizes as ``c_int``, a ``cudaError_t`` code returned.  The digest covers the
sources and flags, so an edited kernel rebuilds and a stale library is never
loaded.  Nothing is built when a module is imported: ``load`` builds at the
kernel's first launch, and ``build`` builds several sources in parallel (one
``nvcc`` each).  There is no fallback when the build fails: it raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry points of each kernel library and their argument types
SIGNATURES = {
    "paged_decode_attention": (
        ("paged_decode_attention_launch", [_P] * 6 + [_I] * 10 + [_P]),
    ),
    "paged_prefill_attention": (
        ("paged_prefill_attention_launch", [_P] * 7 + [_I] * 11 + [_P]),
    ),
    "decode_attention": (
        ("decode_attention_launch", [_P] * 5 + [_I] * 10 + [_P]),
        ("decode_attention_partial_launch", [_P] * 6 + [_I] * 10 + [_P]),
        ("combine_splits_launch", [_P] * 3 + [_I] * 6 + [_P]),
    ),
    "decode_attention_fp8": (
        ("decode_attention_launch", [_P] * 5 + [_I] * 10 + [_P]),
        ("decode_attention_partial_launch", [_P] * 6 + [_I] * 10 + [_P]),
    ),
    "prefill_attention": (
        ("prefill_attention_launch", [_P] * 6 + [_I] * 11 + [_P]),
    ),
    "paged_verify_attention": (
        ("paged_verify_attention_launch", [_P] * 8 + [_I] * 12 + [_P]),
    ),
    "paged_tree_verify_attention": (
        ("paged_tree_verify_attention_launch", [_P] * 9 + [_I] * 12 + [_P]),
    ),
    "verify_attention": (
        ("verify_attention_launch", [_P] * 7 + [_I] * 12 + [_P]),
        ("tree_verify_attention_launch", [_P] * 8 + [_I] * 12 + [_P]),
    ),
    "ssm_scan": (
        ("ssm_scan_chunk_launch", [_P] * 9 + [_I] * 5 + [_P]),
        ("ssm_scan_bwd_launch", [_P] * 17 + [_I] * 5 + [_P]),
    ),
    "flash_attention": (
        ("flash_attention_fwd_launch", [_P] * 5 + [_I] * 7 + [_P]),
        ("flash_attention_bwd_launch", [_P] * 10 + [_I] * 7 + [_P]),
    ),
}
KERNELS = tuple(SIGNATURES)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: K / V dtypes of the dense decode kernel (#3 and its partial form) alone:
#: q's own, or an 8-bit cache's (the serve steps' ``cache_dtype``)
KV_DTYPE_CODES = {**DTYPE_CODES, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}

_LIBS: dict = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (CUDA toolkit required to build kernels)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cuh")) + [SRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: (seconds, compiler
    output)}`` for the libraries it built; raises ``KernelBuildError`` if
    any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out, time.monotonic(),
        )
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = (time.monotonic() - t0, log)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed, with its entry
    points' ``argtypes`` / ``restype`` declared."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in SIGNATURES[name]:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if the launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def require(cond: bool, msg: str) -> None:
    """Validate a kernel argument; raises ``ValueError``."""
    if not cond:
        raise ValueError(msg)
