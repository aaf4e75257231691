"""The tile mesh: the P-chunk step spread over several devices.

Port of ``vcp_tpu/parallel/mesh.py``. A mesh is a (data, tile) grid of
devices:

* ``data`` -- independent streams, one per mesh row, no communication;
* ``tile`` -- horizontal bands of one frame. Each band runs the whole P
  step (``gop_ops._pstep_core`` with ``row0``: search, sub-pel ladder,
  chroma MC, transform, quantisation, decimation) against the full
  reference held on its device; the reconstructed bands are then
  gathered to every device of the row, where the frame-global deblock
  runs on the whole planes, so each device holds the next frame's full
  reference.

``vcp_tpu`` runs this under ``shard_map`` and gathers with
``jax.lax.all_gather`` over ICI. Here one host thread (a single
controller, as JAX is) issues each band's work to that band's device, and
each gather is an explicit ``Tensor.to(device, non_blocking=True)`` copy
of every band to every distinct device of the row; there is no
``torch.distributed`` and no NCCL. A device list that repeats one device
(``[cuda:0] * 4``, or ``[cpu] * 8`` as the CPU tests use: the counterpart
of XLA's ``--xla_force_host_platform_device_count``) runs the bands one
after another on it, with the same launches and the same bytes.

The band step always takes the exhaustive search, as ``vcp_tpu``'s traced
band row does: at sr >= 12 with sub-pel, where the one-device step takes
the pyramid search, the mesh's stream can differ from the one-device
stream (it equals ``vcp_tpu``'s mesh stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, tile) grid of devices; ``devices[d][t]``."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "tile": len(self.devices[0])}

    @property
    def flat(self) -> list[torch.device]:
        """Every device, data-major (``vcp_tpu``'s ("data", "tile")
        sharding of a batch)."""
        return [d for row in self.devices for d in row]


def visible_devices(device: str | torch.device = "cuda") -> list:
    """The devices an encoder on ``device`` may spread over: every card
    ``torch.cuda`` sees for ``cuda``, the one CPU for ``cpu``."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              tile: int | None = None, devices=None) -> Mesh:
    """A (data, tile) mesh over ``devices`` (default: the visible cards).

    Without ``data`` and ``tile`` the factoring favours tile parallelism
    up to 4 and puts the rest on data, as ``vcp_tpu`` does. Raises when
    fewer devices are given than requested."""
    devs = [torch.device(d) for d in (
        visible_devices("cuda") if devices is None else devices)]
    n = n_devices or len(devs)
    if n < 1 or len(devs) < n:
        kind = devs[0].type if devs else "cuda"
        raise RuntimeError(
            f"make_mesh: {n} devices requested but only {len(devs)} "
            f"visible of type '{kind}'. Pass devices=[...] (a list may "
            "repeat one device, e.g. [torch.device('cpu')] * 8) for a "
            "mesh whose bands share a device.")
    devs = devs[:n]
    if data is None or tile is None:
        tile = tile or min(4, n)
        while n % tile:
            tile -= 1
        data = n // tile
    if data * tile != n:
        raise ValueError(f"make_mesh: {data} x {tile} != {n} devices")
    return Mesh(tuple(tuple(devs[d * tile:(d + 1) * tile])
                      for d in range(data)))


def _to(a, device: torch.device) -> torch.Tensor:
    """``a`` (numpy or tensor, any integer dtype) as int32 on ``device``;
    uploads travel in their own dtype (uint8 frames are a quarter of the
    int32 bytes)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.contiguous().to(device, non_blocking=True).to(torch.int32)


def _gather(bands, device: torch.device) -> torch.Tensor:
    """The bands (in tile order) concatenated on ``device``."""
    return torch.cat([b.to(device, non_blocking=True) for b in bands])


def encode_pchunk_sharded(mesh: Mesh, ys, us, vs, ref_y, ref_u, ref_v,
                          qp: int, qpc: int, sr: int = 8, lam: int = 4,
                          subpel: int = 1, deblock: bool = False):
    """The production P-chunk step sharded over the mesh: stream b on mesh
    row b (B / data streams a row), band t of each frame on device
    ``mesh.devices[row][t]`` at frame row ``t * H / tile``.

    ys/us/vs: (B, N, H, W[/2]) -- B streams of N consecutive P frames;
    ref_*: (B, H, W[/2]) previous reconstructions; numpy or tensors of any
    integer dtype. Deblocking (``deblock``) runs per frame on the gathered
    planes through ``deblock_frame(no_strong=True)`` without a scalar QP:
    the general form without the strong filter, as in ``vcp_tpu``.

    Returns (packed (B, N, nMB * MB_WORDS) int16, recon_y, recon_u,
    recon_v (B, H, W[/2]) int32 of the last frame), on the mesh's first
    device."""
    from ..codec.h264.gop_ops import _pstep_core
    from ..ops import deblock as dbf

    n_data, n_tile = mesh.shape["data"], mesh.shape["tile"]
    b, n, h, w = ys.shape
    band_h = h // n_tile
    assert band_h % 16 == 0 and band_h * n_tile == h, \
        "band height must be MB-aligned"
    if b % n_data:
        raise ValueError(f"encode_pchunk_sharded: {b} streams over "
                         f"{n_data} mesh rows")
    n_mby, n_mbx = h // 16, w // 16
    out_dev = mesh.devices[0][0]

    packed_out, recon_out = [], []
    for bi in range(b):
        row = mesh.devices[bi // (b // n_data)]
        uniq = list(dict.fromkeys(row))
        # each band's frames on its device, the chunk at once; the full
        # references on every distinct device of the row
        bands = [tuple(_to(p[bi, :, t * band_h // s:(t + 1) * band_h // s],
                           row[t]) for p, s in ((ys, 1), (us, 2), (vs, 2)))
                 for t in range(n_tile)]
        refs = {d: tuple(_to(p[bi], d) for p in (ref_y, ref_u, ref_v))
                for d in uniq}
        frames = []
        for k in range(n):
            outs = [_pstep_core(*(p[k] for p in bands[t]), *refs[row[t]],
                                qp, qpc, sr, lam, subpel=subpel,
                                row0=t * band_h)
                    for t in range(n_tile)]
            frames.append(_gather([o[0] for o in outs], out_dev))
            for d in uniq:
                fy, fu, fv = (_gather([o[i] for o in outs], d)
                              for i in (1, 2, 3))
                if deblock:
                    nz4 = _gather([o[4] for o in outs], d)
                    mv = _gather([o[5] for o in outs], d)
                    qp_mb = torch.full((n_mby, n_mbx), qp, dtype=torch.int32,
                                       device=d)
                    intra = torch.zeros((n_mby, n_mbx), dtype=torch.bool,
                                        device=d)
                    fy, fu, fv = dbf.deblock_frame(fy, fu, fv, qp_mb, intra,
                                                   nz4, mv, no_strong=True)
                refs[d] = (fy, fu, fv)
        packed_out.append(torch.stack(frames))
        recon_out.append(tuple(p.to(out_dev, non_blocking=True)
                               for p in refs[row[0]]))
    return (torch.stack(packed_out),
            *(torch.stack([r[i] for r in recon_out]) for i in range(3)))


def encode_iframe_batch_sharded(mesh: Mesh, y, u, v, qp: int, qpc: int):
    """Batch-data-parallel intra step: frames (F, H, W[/2]) in F / n
    contiguous runs over the n devices of the flattened mesh (the intra
    row scan is sequential within a frame), one ``encode_iframe`` a frame
    on its device, without deblocking. Returns recon_y, recon_u, recon_v
    (F, H, W[/2]) uint8 on the mesh's first device."""
    from ..codec.h264.frame_ops import encode_iframe

    devs = mesh.flat
    f = y.shape[0]
    if f % len(devs):
        raise ValueError(f"encode_iframe_batch_sharded: {f} frames over "
                         f"{len(devs)} devices")
    per = f // len(devs)
    outs = [encode_iframe(*(_to(p[i], devs[i // per]) for p in (y, u, v)),
                          qp, qpc)
            for i in range(f)]
    return tuple(_gather([o[k][None] for o in outs], devs[0])
                 for k in ("recon_y", "recon_u", "recon_v"))
