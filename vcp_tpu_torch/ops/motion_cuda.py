"""Wrapper of the hand-written ``motion_search`` CUDA kernel.

``csrc/motion_search.cu`` replaces the two TPU kernels of
``vcp_tpu/ops/motion_pallas.py`` ``full_search_pallas``: ``_kernel_pred``
(``with_pred=True``: search + fused full-pel prediction, the full-pel P
step) and ``_kernel`` (``with_pred=False``: search only, the sub-pel P
step, which interpolates its own prediction). On a CUDA tensor the
wrapper launches the kernel (or raises); on a CPU tensor it runs the
plain PyTorch version, ``motion.full_search`` (+ ``motion.mc_luma``).
``motion_search.launches_with_pred`` and
``motion_search.launches_search_only`` count the launches of each.

The kernel packs samples four to a word, so it takes samples in 0..255
only (the Y4M source and the clamped reconstruction are); a sample
outside that range stops it with a device-side trap, which the next
synchronise reports.

``motion_search_ref`` runs the earlier design of the same source (one
thread block per MB, one offset per thread, int32 samples). It is an
independent reference on the card for checks and timing; no encode path
calls it and it counts no launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import device as devmod

MAX_SEARCH_RANGE = 32       # shared window (16 + 2*sr) rows <= 31 KB


def _lib() -> ctypes.CDLL:
    lib = devmod.kernel_lib("motion_search.cu")
    if lib.vcp_motion_search.argtypes is None:
        c_int, vp = ctypes.c_int, ctypes.c_void_p
        for fn in (lib.vcp_motion_search, lib.vcp_motion_search_ref):
            fn.restype = c_int
            fn.argtypes = [vp, vp, c_int, c_int, c_int, c_int, vp, vp, vp]
        lib.vcp_motion_search_plan.restype = None
        lib.vcp_motion_search_plan.argtypes = [c_int] * 3 + [vp]
    return lib


def _launch(fn_name: str, cur, ref, sr: int, lam: int, with_pred: bool):
    dev = cur.device
    devmod.require_cuda_int32("cur", cur, dev)
    devmod.require_cuda_int32("ref", ref, dev)
    h, w = cur.shape
    if ref.shape != cur.shape or h % 16 or w % 16:
        raise ValueError(f"motion_search: shapes {tuple(cur.shape)} / "
                         f"{tuple(ref.shape)} must match, multiples of 16")
    if not 0 <= sr <= MAX_SEARCH_RANGE:
        raise ValueError(f"motion_search: search range {sr} outside "
                         f"0..{MAX_SEARCH_RANGE}")
    # the kernel reads both planes with 16-byte loads; a fresh allocation
    # is aligned, a view at an odd offset is copied
    cur, ref = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (cur, ref))
    mv = torch.empty((h // 16, w // 16, 2), dtype=torch.int32, device=dev)
    pred = torch.empty_like(cur) if with_pred else None
    lib = _lib()
    err = getattr(lib, fn_name)(
        devmod.ptr(cur), devmod.ptr(ref), h, w, sr, int(lam),
        devmod.ptr(mv), devmod.ptr(pred), devmod.stream_ptr(cur))
    devmod.check_launch(lib, err, fn_name)
    return (mv, pred) if with_pred else mv


def motion_search(cur: torch.Tensor, ref: torch.Tensor, search_range: int,
                  lam: int, with_pred: bool = False):
    """Full-pel exhaustive search (see ``motion.full_search``).

    cur, ref: (H, W) int32 samples 0..255, H and W multiples of 16.
    Returns mv (nMBy, nMBx, 2) int32 [dy, dx], plus the (H, W) int32
    full-pel prediction when ``with_pred``."""
    sr = int(search_range)
    if not cur.is_cuda:
        from .motion import full_search, mc_luma
        mv, _ = full_search(cur, ref, sr, lam)
        return (mv, mc_luma(ref, mv, sr)) if with_pred else mv
    out = _launch("vcp_motion_search", cur, ref, sr, lam, with_pred)
    if with_pred:
        motion_search.launches_with_pred += 1
    else:
        motion_search.launches_search_only += 1
    return out


def motion_search_ref(cur: torch.Tensor, ref: torch.Tensor,
                      search_range: int, lam: int, with_pred: bool = False):
    """``motion_search`` by the reference design (CUDA tensors only)."""
    return _launch("vcp_motion_search_ref", cur, ref, int(search_range), lam,
                   with_pred)


def launch_plan(h: int, w: int, search_range: int) -> dict:
    """The launch ``motion_search`` makes for an (h, w) plane: run length
    (offsets per thread), MBs per block, threads per block and dynamic
    shared-memory bytes per block."""
    out = (ctypes.c_int * 4)()
    _lib().vcp_motion_search_plan(h, w, int(search_range), out)
    return {"run": out[0], "mbs_per_block": out[1], "threads": out[2],
            "smem_bytes": out[3]}


motion_search.launches_with_pred = 0
motion_search.launches_search_only = 0
