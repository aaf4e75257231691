"""Wrappers of the hand-written deblocking CUDA kernels.

``csrc/deblock.cu`` replaces two TPU kernels of
``vcp_tpu/ops/deblock_pallas.py``: ``deblock_fast`` the uniform-QP
all-inter ``_kernel_fast`` (``wavefront_pallas_fast``), and
``deblock_general`` the threshold-grid ``_kernel`` (``wavefront_pallas``,
strong filter optional). On CUDA tensors each wrapper launches its kernel
(one grid per wavefront diagonal, all on the current stream) or raises;
on CPU tensors it runs the plain PyTorch version in ``deblock``. Each
wrapper's ``launches`` counts its calls that launched the kernel (one
call = one frame = d_steps grid launches); ``deblock_general`` counts
its ``strong=False`` instantiation apart, in ``launches_no_strong``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import device as devmod


def _lib() -> ctypes.CDLL:
    lib = devmod.kernel_lib("deblock.cu")
    if lib.vcp_deblock_fast.argtypes is None:
        c_int, vp = ctypes.c_int, ctypes.c_void_p
        lib.vcp_deblock_fast.restype = c_int
        lib.vcp_deblock_fast.argtypes = [vp, vp, vp, c_int, c_int,
                                         vp, vp, vp, vp, vp]
        lib.vcp_deblock_general.restype = c_int
        lib.vcp_deblock_general.argtypes = [vp, vp, vp, c_int, c_int,
                                            vp, vp, vp, vp, vp, c_int, vp]
    return lib


def _diagonal_activity(act_mb: torch.Tensor) -> torch.Tensor:
    """(nMBy, nMBx) bool MB activity → (d_steps,) int32 per diagonal
    d = mbx + 2*mby (nonzero where any MB on it has a bS > 0 edge)."""
    n_mby, n_mbx = act_mb.shape
    dev = act_mb.device
    diag = (torch.arange(n_mbx, device=dev)[None, :]
            + 2 * torch.arange(n_mby, device=dev)[:, None]).reshape(-1)
    act = torch.zeros(n_mbx + 2 * (n_mby - 1), dtype=torch.int32,
                      device=dev)
    return act.index_add_(0, diag, act_mb.reshape(-1).to(torch.int32))


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


def deblock_fast(y, u, v, bs_v, bs_h, scal):
    """Uniform-QP all-inter filter (bS <= 3). y (H, W), u/v (H/2, W/2)
    int32; bs_v (W/4-1, H/4), bs_h (H/4-1, W/4) int32 from
    ``deblock.compute_bs_luma``; ``scal`` the ten ints of
    ``deblock.deblock_scalars``. Returns new filtered planes."""
    if not y.is_cuda:
        from .deblock import deblock_fast_plain
        return deblock_fast_plain(y, u, v, bs_v, bs_h, scal)
    dev, h, w = _check_planes(y, u, v)
    _check_grid("bs_v", bs_v, dev, (w // 4 - 1, h // 4))
    _check_grid("bs_h", bs_h, dev, (h // 4 - 1, w // 4))
    if len(scal) != 10:
        raise ValueError("deblock_fast: need ten scalar thresholds")
    n_mby, n_mbx = h // 16, w // 16
    zc = torch.zeros((1, h // 4), dtype=torch.int32, device=dev)
    zr = torch.zeros((1, w // 4), dtype=torch.int32, device=dev)
    act_v = torch.cat([zc, bs_v]).reshape(n_mbx, 4, n_mby, 4) \
        .amax(dim=(1, 3)).T
    act_h = torch.cat([zr, bs_h]).reshape(n_mby, 4, n_mbx, 4) \
        .amax(dim=(1, 3))
    act = _diagonal_activity((act_v + act_h) > 0)
    yo, uo, vo = y.clone(), u.clone(), v.clone()
    scal_host = (ctypes.c_int32 * 10)(*(int(s) for s in scal))
    lib = _lib()
    err = lib.vcp_deblock_fast(
        devmod.ptr(yo), devmod.ptr(uo), devmod.ptr(vo), h, w,
        devmod.ptr(bs_v), devmod.ptr(bs_h), devmod.ptr(act),
        ctypes.cast(scal_host, ctypes.c_void_p), devmod.stream_ptr(y))
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
    dev, h, w = _check_planes(y, u, v)
    hc, wc = h // 2, w // 2
    _check_grid("vthr", vthr, dev, (4, h, w // 4))
    _check_grid("hthr", hthr, dev, (4, h // 4, w))
    _check_grid("cvthr", cvthr, dev, (4, hc, wc // 4))
    _check_grid("chthr", chthr, dev, (4, hc // 4, wc))
    n_mby, n_mbx = h // 16, w // 16
    act_mb = (vthr[0].reshape(n_mby, 16, n_mbx, 4).amax(dim=(1, 3))
              + hthr[0].reshape(n_mby, 4, n_mbx, 16).amax(dim=(1, 3))
              + cvthr[0].reshape(n_mby, 8, n_mbx, 2).amax(dim=(1, 3))
              + chthr[0].reshape(n_mby, 2, n_mbx, 8).amax(dim=(1, 3))) > 0
    act = _diagonal_activity(act_mb)
    yo, uo, vo = y.clone(), u.clone(), v.clone()
    lib = _lib()
    err = lib.vcp_deblock_general(
        devmod.ptr(yo), devmod.ptr(uo), devmod.ptr(vo), h, w,
        devmod.ptr(vthr), devmod.ptr(hthr), devmod.ptr(cvthr),
        devmod.ptr(chthr), devmod.ptr(act), 1 if strong else 0,
        devmod.stream_ptr(y))
    devmod.check_launch(lib, err, "deblock_general")
    if strong:
        deblock_general.launches += 1
    else:
        deblock_general.launches_no_strong += 1
    return yo, uo, vo


deblock_fast.launches = 0
deblock_general.launches = 0            # strong=True instantiation
deblock_general.launches_no_strong = 0  # strong=False instantiation
