"""Wrappers of the hand-written deblocking CUDA kernels.

``csrc/deblock.cu`` replaces two TPU kernels of
``vcp_tpu/ops/deblock_pallas.py``: ``deblock_fast`` the uniform-QP
all-inter ``_kernel_fast`` (``wavefront_pallas_fast``), and
``deblock_general`` the threshold-grid ``_kernel`` (``wavefront_pallas``,
strong filter optional). On CUDA tensors each wrapper launches its kernel
or raises; on CPU tensors it runs the plain PyTorch version in
``deblock``. One call is one kernel launch, ``deblock_wave``, that carries
the whole spec-order wavefront of a frame; the wrapper allocates the
output planes (the kernel writes every sample of them) and the zeroed
progress counters the kernel's blocks synchronise through. Each wrapper's
``launches`` counts its calls that launched the kernel;
``deblock_general`` counts its ``strong=False`` instantiation apart, in
``launches_no_strong``. Every launch is made on the device of its planes
(the current device may be another card), and the scratch is allocated
there, per call.

``deblock_fast_diag`` and ``deblock_general_diag`` run the earlier design
(one grid launch per wavefront diagonal) of the same source. They are an
independent reference on the card for checks and timing; no encode path
calls them and they count no launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import device as devmod


def _lib() -> ctypes.CDLL:
    lib = devmod.kernel_lib("deblock.cu")
    if lib.vcp_deblock_fast.argtypes is None:
        c_int, vp = ctypes.c_int, ctypes.c_void_p
        for fn, args in (
                (lib.vcp_deblock_fast,
                 [vp] * 6 + [c_int, c_int] + [vp] * 5),
                (lib.vcp_deblock_general,
                 [vp] * 6 + [c_int, c_int] + [vp] * 5 + [c_int, vp]),
                (lib.vcp_deblock_fast_diag,
                 [vp] * 3 + [c_int, c_int] + [vp] * 4),
                (lib.vcp_deblock_general_diag,
                 [vp] * 3 + [c_int, c_int] + [vp] * 4 + [c_int, vp])):
            fn.restype = c_int
            fn.argtypes = args
    return lib


def _check_planes(y, u, v):
    dev = y.device
    for name, t in (("y", y), ("u", u), ("v", v)):
        devmod.require_cuda_int32(name, t, dev)
    h, w = y.shape
    if h % 16 or w % 16 or tuple(u.shape) != (h // 2, w // 2) \
            or u.shape != v.shape:
        raise ValueError(f"deblock: bad plane shapes {tuple(y.shape)}, "
                         f"{tuple(u.shape)}, {tuple(v.shape)}")
    return dev, h, w


def _check_grid(name, t, dev, shape):
    devmod.require_cuda_int32(name, t, dev)
    if tuple(t.shape) != shape:
        raise ValueError(f"deblock: {name} shape {tuple(t.shape)} != "
                         f"{shape}")


def _check_fast(y, u, v, bs_v, bs_h, scal):
    dev, h, w = _check_planes(y, u, v)
    _check_grid("bs_v", bs_v, dev, (w // 4 - 1, h // 4))
    _check_grid("bs_h", bs_h, dev, (h // 4 - 1, w // 4))
    if len(scal) != 10:
        raise ValueError("deblock_fast: need ten scalar thresholds")
    scal_host = (ctypes.c_int32 * 10)(*(int(s) for s in scal))
    return h, w, ctypes.cast(scal_host, ctypes.c_void_p)


def _check_general(y, u, v, vthr, hthr, cvthr, chthr):
    dev, h, w = _check_planes(y, u, v)
    hc, wc = h // 2, w // 2
    _check_grid("vthr", vthr, dev, (4, h, w // 4))
    _check_grid("hthr", hthr, dev, (4, h // 4, w))
    _check_grid("cvthr", cvthr, dev, (4, hc, wc // 4))
    _check_grid("chthr", chthr, dev, (4, hc // 4, wc))
    return h, w


def _aligned(*tensors):
    """The tensors, each at a 16-byte aligned address: the kernel fetches
    planes and grids with 16-byte loads. A fresh allocation always is; a
    view at an odd offset is copied."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in tensors)


def _outputs(y, u, v):
    """Output planes (every sample is written by the kernel) and the
    zeroed scratch of the wavefront: one progress counter per MB row and
    the ticket counter."""
    progress = torch.zeros(y.shape[0] // 16 + 1, dtype=torch.int32,
                           device=y.device)
    return torch.empty_like(y), torch.empty_like(u), torch.empty_like(v), \
        progress


def deblock_fast(y, u, v, bs_v, bs_h, scal):
    """Uniform-QP all-inter filter (bS <= 3). y (H, W), u/v (H/2, W/2)
    int32; bs_v (W/4-1, H/4), bs_h (H/4-1, W/4) int32 from
    ``deblock.compute_bs_luma``; ``scal`` the ten ints of
    ``deblock.deblock_scalars``. Returns new filtered planes."""
    if not y.is_cuda:
        from .deblock import deblock_fast_plain
        return deblock_fast_plain(y, u, v, bs_v, bs_h, scal)
    h, w, scal_host = _check_fast(y, u, v, bs_v, bs_h, scal)
    y, u, v = _aligned(y, u, v)
    with torch.cuda.device(y.device):
        yo, uo, vo, progress = _outputs(y, u, v)
        lib = _lib()
        err = lib.vcp_deblock_fast(
            devmod.ptr(y), devmod.ptr(u), devmod.ptr(v),
            devmod.ptr(yo), devmod.ptr(uo), devmod.ptr(vo), h, w,
            devmod.ptr(bs_v), devmod.ptr(bs_h), scal_host,
            devmod.ptr(progress), devmod.stream_ptr(y))
        devmod.check_launch(lib, err, "deblock_fast")
    deblock_fast.launches += 1
    return yo, uo, vo


def deblock_general(y, u, v, vthr, hthr, cvthr, chthr, strong: bool = True):
    """Threshold-grid filter: (4, ...) grids of (bS, alpha, beta, tc0)
    from ``deblock.threshold_grids``; ``strong`` enables the bS 4
    filter. Returns new filtered planes."""
    if not y.is_cuda:
        from .deblock import deblock_general_plain
        return deblock_general_plain(y, u, v, vthr, hthr, cvthr, chthr,
                                     strong=strong)
    h, w = _check_general(y, u, v, vthr, hthr, cvthr, chthr)
    y, u, v, vthr, hthr, cvthr, chthr = _aligned(y, u, v, vthr, hthr, cvthr,
                                                 chthr)
    with torch.cuda.device(y.device):
        yo, uo, vo, progress = _outputs(y, u, v)
        lib = _lib()
        err = lib.vcp_deblock_general(
            devmod.ptr(y), devmod.ptr(u), devmod.ptr(v),
            devmod.ptr(yo), devmod.ptr(uo), devmod.ptr(vo), h, w,
            devmod.ptr(vthr), devmod.ptr(hthr), devmod.ptr(cvthr),
            devmod.ptr(chthr), devmod.ptr(progress), 1 if strong else 0,
            devmod.stream_ptr(y))
        devmod.check_launch(lib, err, "deblock_general")
    if strong:
        deblock_general.launches += 1
    else:
        deblock_general.launches_no_strong += 1
    return yo, uo, vo


def deblock_fast_diag(y, u, v, bs_v, bs_h, scal):
    """``deblock_fast`` by the per-diagonal reference kernels (CUDA
    tensors only): one grid launch per wavefront diagonal, in place on
    copies of the planes."""
    h, w, scal_host = _check_fast(y, u, v, bs_v, bs_h, scal)
    yo, uo, vo = y.clone(), u.clone(), v.clone()
    with torch.cuda.device(y.device):
        lib = _lib()
        err = lib.vcp_deblock_fast_diag(
            devmod.ptr(yo), devmod.ptr(uo), devmod.ptr(vo), h, w,
            devmod.ptr(bs_v), devmod.ptr(bs_h), scal_host,
            devmod.stream_ptr(y))
        devmod.check_launch(lib, err, "deblock_fast_diag")
    return yo, uo, vo


def deblock_general_diag(y, u, v, vthr, hthr, cvthr, chthr,
                         strong: bool = True):
    """``deblock_general`` by the per-diagonal reference kernels (CUDA
    tensors only)."""
    h, w = _check_general(y, u, v, vthr, hthr, cvthr, chthr)
    yo, uo, vo = y.clone(), u.clone(), v.clone()
    with torch.cuda.device(y.device):
        lib = _lib()
        err = lib.vcp_deblock_general_diag(
            devmod.ptr(yo), devmod.ptr(uo), devmod.ptr(vo), h, w,
            devmod.ptr(vthr), devmod.ptr(hthr), devmod.ptr(cvthr),
            devmod.ptr(chthr), 1 if strong else 0, devmod.stream_ptr(y))
        devmod.check_launch(lib, err, "deblock_general_diag")
    return yo, uo, vo


deblock_fast.launches = 0
deblock_general.launches = 0            # strong=True instantiation
deblock_general.launches_no_strong = 0  # strong=False instantiation
