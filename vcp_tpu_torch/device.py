"""Device selection and the build + load of the port's CUDA kernels.

Every entry point of the port takes a ``device`` argument that defaults
to ``"cuda"``; :func:`resolve_device` raises when CUDA is asked for and
no card is present, so nothing silently falls back to the CPU.

The kernels under ``csrc/*.cu`` are plain CUDA C++ with a C interface.
:func:`kernel_lib` compiles each source once with ``nvcc`` for ``sm_90a``
into a shared library under ``_build/`` (keyed by a hash of source and
flags, so an edit rebuilds), loads it with ``ctypes`` and returns the
handle. All sources are compiled in parallel, one ``nvcc`` each. A failed
build raises with the compiler's output; a failed launch raises through
:func:`check_launch`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("motion_search.cu", "deblock.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_constants: dict[tuple[str, str], torch.Tensor] = {}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is requested but
    unavailable (callers pass ``device="cpu"`` for the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def constant(name: str, value, device: torch.device,
             dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """A constant table as a tensor on ``device``, uploaded once per
    device: a host-to-device copy from pageable memory synchronizes the
    stream, so per-call uploads would stall the host behind the device."""
    key = (name, str(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.as_tensor(np.asarray(value), dtype=dtype,
                                              device=device)
    return t


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _so_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC_DIR, src), "rb") as fh:
        h.update(fh.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_kernels(sources=SOURCES) -> dict[str, str]:
    """Compile every stale source, all ``nvcc`` processes started
    together. Returns {source: .so path}; raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {src: _so_path(src) for src in sources}
    procs = []
    for src, so in paths.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src}:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("nvcc build failed:\n" + "\n".join(errors))
    return paths


def kernel_lib(src: str) -> ctypes.CDLL:
    """Loaded library of ``csrc/<src>`` (built on first use; the first
    kernel of ``SOURCES`` asked for builds them all)."""
    with _lock:
        lib = _loaded.get(src)
        if lib is None:
            so = build_kernels(SOURCES if src in SOURCES else (src,))[src]
            lib = ctypes.CDLL(so)
            lib.vcp_error_string.restype = ctypes.c_char_p
            lib.vcp_error_string.argtypes = [ctypes.c_int]
            _loaded[src] = lib
        return lib


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        msg = lib.vcp_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def require_cuda_int32(name: str, t: torch.Tensor,
                       device: torch.device) -> None:
    """Validate a kernel argument: int32, contiguous, on ``device``."""
    if t.device != device or t.dtype != torch.int32 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
