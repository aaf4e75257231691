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
"""

from __future__ import annotations

import ctypes

import torch

from .. import device as devmod

MAX_SEARCH_RANGE = 32       # shared window (16 + 2*sr)^2 int32 <= 26 KB


def _lib() -> ctypes.CDLL:
    lib = devmod.kernel_lib("motion_search.cu")
    fn = lib.vcp_motion_search
    if fn.argtypes is None:
        c_int, vp = ctypes.c_int, ctypes.c_void_p
        fn.restype = c_int
        fn.argtypes = [vp, vp, c_int, c_int, c_int, c_int, vp, vp, vp]
    return lib


def motion_search(cur: torch.Tensor, ref: torch.Tensor, search_range: int,
                  lam: int, with_pred: bool = False):
    """Full-pel exhaustive search (see ``motion.full_search``).

    cur, ref: (H, W) int32, H and W multiples of 16. Returns mv (nMBy,
    nMBx, 2) int32 [dy, dx], plus the (H, W) int32 full-pel prediction
    when ``with_pred``."""
    sr = int(search_range)
    if not cur.is_cuda:
        from .motion import full_search, mc_luma
        mv, _ = full_search(cur, ref, sr, lam)
        return (mv, mc_luma(ref, mv, sr)) if with_pred else mv
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
    mv = torch.empty((h // 16, w // 16, 2), dtype=torch.int32, device=dev)
    pred = torch.empty_like(cur) if with_pred else None
    lib = _lib()
    err = lib.vcp_motion_search(
        devmod.ptr(cur), devmod.ptr(ref), h, w, sr, int(lam),
        devmod.ptr(mv), devmod.ptr(pred), devmod.stream_ptr(cur))
    devmod.check_launch(lib, err, "motion_search")
    if with_pred:
        motion_search.launches_with_pred += 1
        return mv, pred
    motion_search.launches_search_only += 1
    return mv


motion_search.launches_with_pred = 0
motion_search.launches_search_only = 0
