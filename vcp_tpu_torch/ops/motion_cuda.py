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

With ``row0`` the search runs for a band: ``cur`` is a horizontal band of
a frame that starts at frame row ``row0`` of the taller reference (the
tile mesh's P step, ``parallel.mesh``). Every launch is made on the
device of its tensors, with that card's SM count in the launch plan.

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
import functools

import torch

from .. import device as devmod

MAX_SEARCH_RANGE = 32       # shared window (16 + 2*sr) rows <= 31 KB


def _lib() -> ctypes.CDLL:
    lib = devmod.kernel_lib("motion_search.cu")
    if lib.vcp_motion_search.argtypes is None:
        c_int, vp = ctypes.c_int, ctypes.c_void_p
        lib.vcp_motion_search.restype = c_int
        lib.vcp_motion_search.argtypes = \
            [vp, vp] + [c_int] * 6 + [vp, vp, c_int, vp]
        lib.vcp_motion_search_ref.restype = c_int
        lib.vcp_motion_search_ref.argtypes = [vp, vp] + [c_int] * 4 \
            + [vp] * 3
        lib.vcp_motion_search_plan.restype = None
        lib.vcp_motion_search_plan.argtypes = [c_int] * 4 + [vp]
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_shapes(cur, ref, sr: int, row0: int) -> None:
    """Raise unless ``cur`` is a band of MB rows of ``ref`` from frame
    row ``row0`` (the whole frame at row0 0) and sr is in range."""
    hb, w = cur.shape
    h_ref = ref.shape[0]
    if ref.dim() != 2 or ref.shape[1] != w or hb % 16 or w % 16 \
            or row0 % 16 or row0 < 0 or row0 + hb > h_ref:
        raise ValueError(f"motion_search: band {tuple(cur.shape)} at row "
                         f"{row0} of reference {tuple(ref.shape)}: need "
                         "the same width, multiples of 16, row0 % 16 == 0 "
                         "and row0 + band height <= reference height")
    if not 0 <= sr <= MAX_SEARCH_RANGE:
        raise ValueError(f"motion_search: search range {sr} outside "
                         f"0..{MAX_SEARCH_RANGE}")


def _launch(fn_name: str, cur, ref, sr: int, lam: int, with_pred: bool,
            row0: int = 0):
    dev = cur.device
    devmod.require_cuda_int32("cur", cur, dev)
    devmod.require_cuda_int32("ref", ref, dev)
    _check_shapes(cur, ref, sr, row0)
    h, w = cur.shape
    # the kernel reads both planes with 16-byte loads; a fresh allocation
    # is aligned, a view at an odd offset is copied
    cur, ref = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (cur, ref))
    with torch.cuda.device(dev):
        mv = torch.empty((h // 16, w // 16, 2), dtype=torch.int32,
                         device=dev)
        pred = torch.empty_like(cur) if with_pred else None
        lib = _lib()
        if fn_name == "vcp_motion_search_ref":
            err = lib.vcp_motion_search_ref(
                devmod.ptr(cur), devmod.ptr(ref), h, w, sr, int(lam),
                devmod.ptr(mv), devmod.ptr(pred), devmod.stream_ptr(cur))
        else:
            err = lib.vcp_motion_search(
                devmod.ptr(cur), devmod.ptr(ref), h, w, ref.shape[0], row0,
                sr, int(lam), devmod.ptr(mv), devmod.ptr(pred),
                _sm_count(dev.index), devmod.stream_ptr(cur))
        devmod.check_launch(lib, err, fn_name)
    return (mv, pred) if with_pred else mv


def motion_search(cur: torch.Tensor, ref: torch.Tensor, search_range: int,
                  lam: int, with_pred: bool = False, row0: int = 0):
    """Full-pel exhaustive search (see ``motion.full_search``).

    cur: (Hb, W) int32 samples 0..255, the band of MB rows from frame row
    ``row0`` of ref: (H, W) (the whole frame: row0 0, Hb == H); Hb, W and
    row0 multiples of 16, row0 + Hb <= H, else ``ValueError``. Returns mv
    (Hb/16, W/16, 2) int32 [dy, dx], plus the (Hb, W) int32 full-pel
    prediction when ``with_pred``."""
    sr, row0 = int(search_range), int(row0)
    if not cur.is_cuda:
        _check_shapes(cur, ref, sr, row0)
        from .motion import full_search, mc_luma
        mv, _ = full_search(cur, ref, sr, lam, row0)
        return (mv, mc_luma(ref, mv, sr, row0)) if with_pred else mv
    out = _launch("vcp_motion_search", cur, ref, sr, lam, with_pred, row0)
    if with_pred:
        motion_search.launches_with_pred += 1
    else:
        motion_search.launches_search_only += 1
    return out


def motion_search_ref(cur: torch.Tensor, ref: torch.Tensor,
                      search_range: int, lam: int, with_pred: bool = False):
    """``motion_search`` by the reference design (CUDA tensors only,
    whole frames only)."""
    if cur.shape != ref.shape:
        raise ValueError("motion_search_ref: whole frames only")
    return _launch("vcp_motion_search_ref", cur, ref, int(search_range), lam,
                   with_pred)


def launch_plan(h: int, w: int, search_range: int,
                device: torch.device) -> dict:
    """The launch ``motion_search`` makes for an (h, w) plane or band on
    the CUDA ``device``: run length (offsets per thread), MBs per block,
    threads per block and dynamic shared-memory bytes per block."""
    out = (ctypes.c_int * 4)()
    _lib().vcp_motion_search_plan(h, w, int(search_range),
                                  _sm_count(devmod.resolve_device(device)
                                            .index), out)
    return {"run": out[0], "mbs_per_block": out[1], "threads": out[2],
            "smem_bytes": out[3]}


motion_search.launches_with_pred = 0
motion_search.launches_search_only = 0
