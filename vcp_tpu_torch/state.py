"""Carry encoder state over from ``vcp_tpu``.

The port has no weights: its "parameters" are the codec tables it keeps
as its own copies (quant MF/V of both transforms, chroma QP, deblock
alpha/beta/tc0, CABAC context init, scan and block orders, decimation
weights, the 8x8 intra gather tables; for HEVC the transform matrices,
quant / level scales, chroma QP map, beta / tc tables, CABAC tables,
context inits and scans, the intra angles and mode sets), and its state
is the reference recon plus the QP (HEVC: plus the POC); the half-pel
quality path adds tables and no state. :func:`from_reference` takes
those from the JAX encoder as numpy arrays, checks every table against
the port's copy, and returns the state as tensors on ``device``, so a P
chunk (:class:`EncoderState`) or an HEVC P frame (:class:`HevcState`,
``codec="h265"``) can be seeded mid-GOP from the JAX encoder's recon.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device


def port_tables() -> dict[str, np.ndarray]:
    """Every table the port keeps, by the ``vcp_tpu`` name."""
    from .codec.h264 import (cabac_tables, frame_ops, gop_ops, intra_rd,
                             tables)
    from .ops import deblock, transform, transform8
    return {
        "MF_TABLE": transform.MF_TABLE,
        "V_TABLE": transform.V_TABLE,
        "CHROMA_QP_FULL": transform.CHROMA_QP_FULL,
        "ALPHA": deblock.ALPHA,
        "BETA": deblock.BETA,
        "TC0": deblock.TC0,
        "ZIGZAG_4x4": np.asarray(tables.ZIGZAG_4x4),
        "LUMA_BLK_ORDER": frame_ops.LUMA_BLK_ORDER,
        "DECIMATE_TAB": gop_ops._DECIMATE_TAB,
        "CTX_INIT_I": np.asarray(cabac_tables.CTX_INIT_I),
        "CTX_INIT_PB": np.asarray(cabac_tables.CTX_INIT_PB),
        "MF8_TABLE": transform8.MF8_TABLE,
        "V8_TABLE": transform8.V8_TABLE,
        "ZIGZAG_8x8": transform8.ZIGZAG_8x8,
        "I8_TABS": intra_rd.I8_TABS,
        **hevc_tables(),
    }


def hevc_tables() -> dict[str, np.ndarray]:
    """The HEVC engine's tables as arrays, by the ``vcp_tpu`` name
    (dicts and functions flattened: ``INIT_VALUES`` in ``CTX_SETS``
    order, ``ANGLE`` by mode, ``INV_ANGLE`` as (angle, inverse) rows,
    scans as (x, y) rows)."""
    from .codec import cabac
    from .codec.h265 import ctx, frame_ops, intra_rd
    from .codec.h265.foreign import ANGLE, INV_ANGLE
    from .ops import deblock_hevc, transform_hevc
    out = {f"trans_matrix({n})": transform_hevc.trans_matrix(n)
           for n in (4, 8, 16, 32)}
    out.update({f"coeff_scan({k})": np.asarray(ctx.coeff_scan(k))
                for k in (2, 3, 4, 5)})
    out.update({
        "QUANT_SCALE": transform_hevc.QUANT_SCALE,
        "LEVEL_SCALE": transform_hevc.LEVEL_SCALE,
        "_CHROMA_QP_MAP": transform_hevc._CHROMA_QP_MAP,
        "BETA_TABLE": deblock_hevc.BETA_TABLE,
        "TC_TABLE": deblock_hevc.TC_TABLE,
        "RANGE_TAB_LPS": np.asarray(cabac.RANGE_TAB_LPS),
        "TRANS_IDX_LPS": np.asarray(cabac.TRANS_IDX_LPS),
        "CTX_SETS": np.asarray(list(ctx.CTX_SETS.values())),
        "INIT_VALUES": np.concatenate(
            [np.asarray(ctx.INIT_VALUES[k]) for k in ctx.CTX_SETS], axis=1),
        "ANGLE": np.asarray([ANGLE.get(m, 0) for m in range(35)]),
        "INV_ANGLE": np.asarray(sorted(INV_ANGLE.items())),
        "MODESET": np.asarray(intra_rd.MODESET),
        "ANG_MODES": np.asarray(frame_ops.ANG_MODES),
        "ANG_ANGLE": np.asarray(frame_ops.ANG_ANGLE),
    })
    return out


@dataclasses.dataclass
class EncoderState:
    """Reference recon (uint8 padded planes on the device) and QPs."""
    recon_y: torch.Tensor
    recon_u: torch.Tensor
    recon_v: torch.Tensor
    qp: int
    qpc: int

    @property
    def recon(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.recon_y, self.recon_u, self.recon_v


@dataclasses.dataclass
class HevcState:
    """HEVC reference recon (int32 CTU-padded planes on the device), the
    GOP's QP and the POC of the next frame."""
    recon_y: torch.Tensor
    recon_u: torch.Tensor
    recon_v: torch.Tensor
    qp: int
    poc: int

    @property
    def recon(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.recon_y, self.recon_u, self.recon_v


def from_reference(ref_tables: dict, recon, qp: int,
                   device: str = "cuda", codec: str = "h264",
                   poc: int = 0):
    """State from ``vcp_tpu``: ``ref_tables`` maps table names to the
    reference's numpy arrays (every table of :func:`port_tables` must be
    present and equal), ``recon`` is the (y, u, v) reference planes.
    ``codec="h265"`` returns a :class:`HevcState` (``recon`` are the HEVC
    encoder's padded planes, ``poc`` the POC of the next frame)."""
    from .ops.transform import chroma_qp
    mine = port_tables()
    missing = sorted(set(mine) - set(ref_tables))
    if missing:
        raise ValueError(f"reference tables missing: {missing}")
    for name, arr in mine.items():
        ref = np.asarray(ref_tables[name])
        if ref.shape != arr.shape or not np.array_equal(ref, arr):
            raise ValueError(f"table {name} differs from the reference")
    dev = resolve_device(device)
    if codec == "h265":
        y, u, v = (torch.from_numpy(np.array(p, np.int32)).to(dev)
                   for p in recon)
        return HevcState(y, u, v, int(qp), int(poc))
    y, u, v = (torch.from_numpy(np.array(p, np.uint8)).to(dev)
               for p in recon)
    return EncoderState(y, u, v, int(qp), chroma_qp(int(qp)))
