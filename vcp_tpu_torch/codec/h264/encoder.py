"""H.264 encoder orchestration: device math + host entropy + mux.

Port of the single-device GOP coders of ``vcp_tpu/codec/h264/encoder.py``.
Without B pictures, per GOP the IDR and every P chunk (8/4/2/1 frames)
are dispatched to the device first, chained on the device-resident
recon, each chunk's compacted entropy rows packed into one buffer whose
copy to the host starts at once; then the chunks are read in order and
written by the host CABAC slice writers. With B pictures
(``_encode_gop_b``) the GOP is an IDR,
P anchors every bframes+1 display frames (the per-frame P step of
``pframe``: partitions and the intra overlay at the quality presets) and
non-reference B pictures between them (``gop_ops.encode_bframe``),
dispatched in decode order with each frame's entropy inputs packed into
one int16 buffer on the device (by default only its nonzero 16-word
chunks cross the bus, ``VCP_SPARSE_B``), then fetched and written in that
order. Both coders upload by default only the 16x16 source tiles that
changed since the previous frame against a source carried on the device
across GOPs (``VCP_DELTA``); ``VCP_DELTA=0`` / ``VCP_SPARSE_B=0`` select
the dense transfers. On ``cuda`` every upload and every P chunk's fetch
goes through pinned host memory, asynchronous to the host.
``encode_frame`` codes one frame at a time (IDR, then P pictures), with
one device step and one slice writer per frame. With more than one card
(or ``VCP_MESH=N``) a GOP without B pictures, 8x8 transform or partitions
goes over the tile mesh (``_encode_gop_mesh``, ``parallel.mesh``):
horizontal bands of each P frame on the mesh's devices, a dense fetch.
``VCP_TIMING=1`` logs one "gop timing" line per GOP, and
``VCP_TRACE_DIR=<dir>`` runs ``encode_stream`` under ``torch.profiler``
and writes its trace there.
Every setting of ``EncoderConfig`` runs, as in ``vcp_tpu``: the speed
shape (effort <= 4: full-pel ME, 4x4 transform, row-pattern I16 IDR),
with or without B pictures, the quality shapes (efforts 5-9: pyramid or
exhaustive full-pel search refined to half-pel at efforts 5-6 and to
quarter-pel at 7-9, adaptive 8x8 transform, RD intra IDR with I16 and i8
MBs, High profile), by default with 2 B pictures, partitioned P anchors
and intra MBs in P pictures, CABAC or CAVLC, and the overrides between
them (``VCP_T8``, ``VCP_RDI``, ``VCP_PARTS``, ``VCP_INTRA_P``,
``VCP_BFRAMES``, ``VCP_CABAC``); an RD intra IDR without the CABAC 8x8
transform is the I16-only ``intra_rd.encode_iframe_rd``.
``encode_file`` reads a Y4M file or decodes H.264 in MP4, MKV or AVI on
the host (``codec.ingest``), scales on the device for ``-s`` / ``-vf
scale`` (``ops.scale``) and muxes the input's audio track
(``codec.audio``).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import mp4 as mp4mod
from ...device import resolve_device
from ...logging import new_logger
from ...ops.scale import scale_yuv420
from ...ops.transform import chroma_qp
from ..args import EncodeParams
from . import entropy, gop_ops, headers

log = new_logger("h264")


class EncodeAbort(RuntimeError):
    pass


def search_range_for_effort(effort: int) -> int:
    """ffmpeg preset ladder (p1..p7 / ultrafast..placebo) → ME window."""
    return (4, 4, 6, 8, 8, 12, 16, 16, 24, 24)[max(0, min(9, effort))]


def subpel_for_effort(effort: int) -> int:
    """Sub-pel ME level per the ffmpeg subme ladder: 0 = full-pel
    (p1-p4/fast), 1 = half-pel (p5-p6/medium), 2 = quarter-pel
    (p7+/slow)."""
    return 0 if effort < 5 else (1 if effort < 7 else 2)


def lam_for_qp(qp: int) -> int:
    """MV-rate bias for the SAD cost (~0.8 * Qstep)."""
    return max(1, int(0.5 * 2 ** (qp / 6)))


@dataclasses.dataclass
class EncoderConfig:
    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    qp: int = 28
    gop_size: int = 30
    effort: int = 4
    deblock: bool = True           # in-loop filter (VCP_DEBLOCK=0 disables)
    cabac: bool = True             # CABAC entropy (VCP_CABAC=0 -> CAVLC)
    bframes: int = 0               # B pictures between anchors (-bf)
    transform8: bool = False       # High-profile adaptive 8x8 transform
    parts: bool = False            # P_8x8 sub-partitions (quality presets)
    rd_intra: bool | None = None   # per-MB RD I16 mode selection
    intra_p: bool | None = None    # intra MBs inside P pictures (None =
                                   # on for the CABAC quality shape)
    params: EncodeParams | None = None   # original preset args (rate control)

    def use_rd_intra(self) -> bool:
        if os.environ.get("VCP_RDI"):
            return os.environ["VCP_RDI"] != "0"
        if self.rd_intra is not None:
            return self.rd_intra
        return self.effort >= 5

    def use_intra_p(self) -> bool:
        """The intra overlay in P pictures (VCP_INTRA_P overrides). It
        needs the partitioned CABAC path and the 8x8-transform PPS (the
        overlay emits I_NxN / i8 MBs)."""
        if os.environ.get("VCP_INTRA_P"):
            return os.environ["VCP_INTRA_P"] != "0"
        if self.intra_p is not None:
            return self.intra_p
        return (self.effort >= 5 and self.cabac and self.parts
                and self.transform8)

    @classmethod
    def from_params(cls, params: EncodeParams, width: int, height: int,
                    fps_num: int, fps_den: int) -> "EncoderConfig":
        """The same settings ``vcp_tpu`` derives from the preset args and
        its environment overrides."""
        cfg = cls(width=width, height=height, fps_num=fps_num,
                  fps_den=fps_den, effort=params.effort)
        if os.environ.get("VCP_DEBLOCK") == "0":
            cfg.deblock = False
        if os.environ.get("VCP_CABAC") == "0":
            cfg.cabac = False
        cfg.transform8 = cfg.cabac and params.effort >= 5
        if os.environ.get("VCP_T8"):
            cfg.transform8 = os.environ["VCP_T8"] != "0"
        cfg.parts = cfg.cabac and params.effort >= 5
        if os.environ.get("VCP_PARTS"):
            cfg.parts = os.environ["VCP_PARTS"] != "0"
        if params.bframes >= 0:
            cfg.bframes = max(0, min(8, params.bframes))
        elif cfg.cabac and params.effort >= 5:
            cfg.bframes = 2
        if os.environ.get("VCP_BFRAMES"):
            cfg.bframes = max(0, min(8, int(os.environ["VCP_BFRAMES"])))
        if params.gop_size:
            cfg.gop_size = params.gop_size
        else:
            cfg.gop_size = max(1, int(round(fps_num / max(1, fps_den))))
        from .ratecontrol import initial_qp
        cfg.qp = initial_qp(params, width, height,
                            fps_num / max(1, fps_den))
        cfg.params = params
        return cfg


def idr_qp(qp: int) -> int:
    """I-frame QP: a few steps below the P QP."""
    return max(0, qp - int(os.environ.get("VCP_QPI_OFFSET", "3")))


class H264Encoder:
    """Stateful per-task encoder: feeds GOPs, emits Annex-B access units.

    ``device`` defaults to ``"cuda"`` (raises without a card); pass
    ``"cpu"`` for the plain PyTorch versions of the kernels."""

    P_CHUNKS = (8, 4, 2, 1)

    def __init__(self, cfg: EncoderConfig, device: str = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # the adaptive 8x8 transform needs the High profile; B pictures
        # need Main at least, poc_type 0 and both anchors in the DPB
        if cfg.bframes > 0:
            self.sp = headers.SeqParams(
                width=cfg.width, height=cfg.height,
                profile_idc=100 if cfg.transform8 else 77, poc_type=0,
                num_ref_frames=2)
        else:
            self.sp = headers.SeqParams(
                width=cfg.width, height=cfg.height,
                **({"profile_idc": 100} if cfg.transform8 else {}))
        self.pp = headers.PicParams(init_qp=26, cabac=cfg.cabac,
                                    transform_8x8=cfg.transform8)
        self.idr_count = 0
        self.frame_index = 0        # frames coded so far (encode_frame's GOP)
        self._frame_num = 0
        self._recon = None          # (y, u, v) uint8 planes on the device
        # host seconds per stage, summed over GOPs: decode (pulling the
        # frames from the input: the Y4M read, or the MP4 demux and host
        # H.264 decode; ``encode_stream`` adds it), the IDR's, the P
        # chunks' or P anchors' and the B pictures' dispatch (pad, pack,
        # upload, enqueue device work; the P anchors' include the intra
        # overlay gate's device->host read), fetch (device->host copies,
        # which wait for the device) and entropy (unpack + CABAC slice
        # writers)
        self.stage_s = {"decode": 0.0, "idr": 0.0, "p": 0.0, "b": 0.0,
                        "fetch": 0.0, "entropy": 0.0}
        # host seconds padding and packing source planes, a part of the
        # idr / p / b dispatch stages (``VCP_TIMING``'s pack_ms)
        self._pack_s = 0.0
        self._last_p_data = None    # entropy input of encode_frame's last P
        # the delta upload's carry: the last uploaded source frame as host
        # MB tiles and as the device's MB-tiled (sy, su, sv); both coders
        # share it, and it passes from GOP to GOP
        self._prev_tiles = None
        self._src_dev = None
        # sticky caps (rows) of a P chunk's one fetch buffer, and (chunks)
        # of each B-GOP buffer kind's word-sparse fetch; grown on overflow
        self._mcap = 512
        self._pcap = 256
        self._spcaps: dict[str, int] = {}
        self.rc = None
        if cfg.params is not None and cfg.params.rate_mode() == "abr":
            from .ratecontrol import RateController
            self.rc = RateController(cfg.params, cfg.width, cfg.height,
                                     cfg.fps_num / max(1, cfg.fps_den))

    def headers_annexb(self) -> bytes:
        """SPS and PPS as Annex-B NAL units (start codes included)."""
        return headers.write_sps(self.sp) + headers.write_pps(self.pp)

    def sps_pps_raw(self) -> tuple[bytes, bytes]:
        """(sps, pps) NAL payloads incl. the NAL header byte, for avcC."""
        return (headers.write_sps(self.sp)[4:],
                headers.write_pps(self.pp)[4:])

    def _pad(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        from .frame_ops import pad_plane
        t0 = time.perf_counter()
        out = (pad_plane(np.asarray(y, np.uint8), 16),
               pad_plane(np.asarray(u, np.uint8), 8),
               pad_plane(np.asarray(v, np.uint8), 8))
        self._pack_s += time.perf_counter() - t0
        return out

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the encoder's device. On ``cuda``
        through a pinned staging tensor of its own and an asynchronous
        copy: PyTorch's pinned allocator hands the staging block out again
        only after that copy has run, so no upload overwrites another."""
        host = torch.from_numpy(np.require(arr, requirements=("C", "W")))
        if self.device.type != "cuda":
            return host
        staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        staged.copy_(host)
        return staged.to(self.device, non_blocking=True)

    def _fetch_async(self, t: torch.Tensor):
        """Start copying a device tensor to the host: (host tensor, event
        or None). On ``cuda`` the copy goes into pinned memory and the
        event marks its end; ``_fetched`` waits on it."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        return host, ev

    def _fetched(self, token) -> np.ndarray:
        """The host array of a ``_fetch_async`` token, once its copy has
        run (the one wait of a P chunk's fetch)."""
        host, ev = token
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def _use_delta(self) -> bool:
        """Upload only the changed 16x16 source tiles against the carried
        source (``gop_ops`` delta tiles): bit-exact, on by default;
        ``VCP_DELTA=0`` selects the dense upload. Read on every call."""
        return os.environ.get("VCP_DELTA", "1") != "0"

    def _delta_carry(self, n_mb: int):
        """The delta upload's (host tiles, device source) at the start of
        a GOP: the carried pair, or fresh zero tiles and no source when
        there is none or the MB count changed."""
        if self._prev_tiles is None or self._prev_tiles.shape[0] != n_mb:
            return np.zeros((n_mb, gop_ops.TILE_WORDS), np.uint8), None
        return self._prev_tiles, self._src_dev

    def _tile_delta(self, planes, prev: np.ndarray, full: bool = False):
        """``gop_ops.tile_delta`` on padded host planes, its host seconds
        counted as packing."""
        t0 = time.perf_counter()
        out = gop_ops.tile_delta(*planes, prev, full=full)
        self._pack_s += time.perf_counter() - t0
        return out

    def _upload_delta(self, deltas: list, n_mb: int):
        """The deltas [(idx, tiles)] of one or more frames padded to one
        bucket and uploaded as ONE buffer: (idx (N, K) int32, tiles (N,
        K, 384) uint8) on the device."""
        t0 = time.perf_counter()
        bucket = gop_ops.delta_bucket(max(len(ix) for ix, _ in deltas), n_mb)
        n, nb = len(deltas), len(deltas) * bucket * 4
        buf = np.empty(nb + n * bucket * gop_ops.TILE_WORDS, np.uint8)
        idx_h = buf[:nb].view(np.int32).reshape(n, bucket)
        tiles_h = buf[nb:].reshape(n, bucket, gop_ops.TILE_WORDS)
        for k, (ix, t) in enumerate(deltas):
            idx_h[k], tiles_h[k] = gop_ops.pad_delta(ix, t, bucket, n_mb)
        self._pack_s += time.perf_counter() - t0
        dev = self._upload(buf)
        return (dev[:nb].view(torch.int32).reshape(n, bucket),
                dev[nb:].reshape(n, bucket, gop_ops.TILE_WORDS))

    def encode_gop(self, frames: list) -> list[tuple]:
        """Encode a list of (y, u, v) frames, the first as IDR and the
        rest as P; returns [(annexb access unit, is_idr)]. With
        ``cfg.bframes`` > 0 and more than two frames the GOP is coded as
        IDR + P anchors + B pictures in decode order, and each item gains
        a third element: the composition-time offset in frames (for the
        MP4 ctts box). A GOP of more than one frame goes over the tile
        mesh when ``_get_mesh`` gives one."""
        t0 = time.perf_counter()
        before = dict(self.stage_s, pack=self._pack_s)
        if self.cfg.bframes > 0 and len(frames) > 2:
            out = self._encode_gop_b(frames)
        else:
            mesh = self._get_mesh() if len(frames) > 1 else None
            out = self._encode_gop_mesh(frames, mesh) if mesh is not None \
                else self._encode_gop_p(frames)
        if os.environ.get("VCP_TIMING") == "1":
            self._log_timing(len(frames), time.perf_counter() - t0, before)
        return out

    def _log_timing(self, n_frames: int, total_s: float,
                    before: dict) -> None:
        """The "gop timing" line: the GOP's wall and its stage seconds
        (pack: padding and packing the source on the host; dispatch: the
        idr, p and b stages without the pack; fetch; entropy)."""
        d = {k: v - before[k]
             for k, v in dict(self.stage_s, pack=self._pack_s).items()}
        dispatch = d["idr"] + d["p"] + d["b"] - d["pack"]
        log.info("gop timing", frames=n_frames,
                 total_ms=f"{total_s * 1e3:.1f}",
                 pack_ms=f"{d['pack'] * 1e3:.1f}",
                 dispatch_ms=f"{dispatch * 1e3:.1f}",
                 fetch_ms=f"{d['fetch'] * 1e3:.1f}",
                 entropy_ms=f"{d['entropy'] * 1e3:.1f}")

    def _get_mesh(self):
        """The tile mesh for a GOP, or None. ``VCP_MESH=0`` turns it off;
        ``VCP_MESH=N`` asks for N devices, capped at the visible ones
        (``parallel.mesh.visible_devices``); without it the mesh starts
        only on ``cuda`` with more than one visible card. Only GOPs
        without B pictures, 8x8 transform or partitions take it. The tile
        count steps down until it divides the MB rows; fewer than 2 tiles
        is no mesh (never a move to the CPU)."""
        from ...parallel import mesh as meshmod
        val = os.environ.get("VCP_MESH", "")
        cfg = self.cfg
        if val == "0" or cfg.bframes > 0 or cfg.transform8 or cfg.parts:
            return None
        devs = meshmod.visible_devices(self.device)
        n = len(devs)
        if val.isdigit() and int(val) > 0:
            want = int(val)
        elif n > 1 and self.device.type == "cuda":
            want = n
        else:
            return None
        t = min(want, n)
        while t > 1 and self.sp.mb_height % t:
            t -= 1
        if t < 2:
            return None
        return meshmod.make_mesh(t, data=1, tile=t, devices=devs)

    def _encode_gop_mesh(self, frames: list, mesh) -> list[tuple]:
        """A GOP without B pictures over the tile mesh: the IDR dense on
        the encoder's device, each P chunk through
        ``parallel.mesh.encode_pchunk_sharded`` (one stream), its packed
        buffer fetched densely and split by ``gop_ops.unpack_frame``."""
        from ...parallel import mesh as meshmod
        cfg = self.cfg
        off = self.pp.chroma_qp_index_offset
        qp = self.rc.gop_qp() if self.rc else cfg.qp
        qp_i = idr_qp(qp) if len(frames) > 1 else qp
        qpc, qpc_i = chroma_qp(qp, off), chroma_qp(qp_i, off)
        sr = search_range_for_effort(cfg.effort)
        lam = lam_for_qp(qp)
        subpel = subpel_for_effort(cfg.effort)
        n_mby, n_mbx = self.sp.mb_height, self.sp.mb_width

        t0 = time.perf_counter()
        iout, ikeys = self._rd_or_row_iframe(
            [self._upload(p) for p in self._pad(*frames[0])], qp_i, qpc_i)
        recon = (iout["recon_y"], iout["recon_u"], iout["recon_v"])
        t1 = time.perf_counter()
        self.stage_s["idr"] += t1 - t0
        idata = {k: iout[k].cpu().numpy() for k in ikeys}
        t2 = time.perf_counter()
        self.stage_s["fetch"] += t2 - t1
        out: list[tuple[bytes, bool]] = [(entropy.write_islice(
            self.sp, self.pp, frame_num=0,
            idr_pic_id=self.idr_count % 65536, qp=qp_i, data=idata,
            deblock=cfg.deblock, poc_lsb=0), True)]
        self.idr_count += 1
        self._frame_num = 1
        self.stage_s["entropy"] += time.perf_counter() - t2

        i = 1
        while i < len(frames):
            chunk = next(c for c in self.P_CHUNKS if c <= len(frames) - i)
            t0 = time.perf_counter()
            pads = [self._pad(*frames[i + k]) for k in range(chunk)]
            planes = [np.stack([p[j] for p in pads])[None] for j in range(3)]
            packed, ry, ru, rv = meshmod.encode_pchunk_sharded(
                mesh, *planes, *(p[None] for p in recon), qp, qpc, sr=sr,
                lam=lam, subpel=subpel, deblock=cfg.deblock)
            recon = tuple(p[0].to(self.device).to(torch.uint8)
                          for p in (ry, ru, rv))
            t1 = time.perf_counter()
            self.stage_s["p"] += t1 - t0
            packed_h = packed[0].cpu().numpy()
            t2 = time.perf_counter()
            self.stage_s["fetch"] += t2 - t1
            for k in range(chunk):
                out.append((entropy.write_pslice(
                    self.sp, self.pp, frame_num=self._frame_num, qp=qp,
                    data=gop_ops.unpack_frame(packed_h[k], n_mby, n_mbx),
                    deblock=cfg.deblock, poc_lsb=2 * len(out)), False))
                self._frame_num += 1
            self.stage_s["entropy"] += time.perf_counter() - t2
            i += chunk
        self._recon = recon
        # the mesh bypasses the delta carry: the next GOP starts it anew
        self._prev_tiles = self._src_dev = None
        self.frame_index += len(frames)
        if self.rc:
            self.rc.update(len(frames), sum(len(nal) for nal, _ in out))
        return out

    def _encode_gop_p(self, frames: list) -> list[tuple]:
        """IDR + P chunks on the encoder's device (see ``encode_gop``).
        With the delta upload the IDR takes the carried source (a delta
        when there is one, else the whole frame) and every P chunk one
        upload of its frames' changed tiles, padded to one bucket. Each P
        chunk's outputs cross the bus as one ``combine_fetch`` buffer
        whose copy starts right after dispatch; rows past the sticky caps
        come in one tail fetch, and the caps grow."""
        cfg = self.cfg
        qp = self.rc.gop_qp() if self.rc else cfg.qp
        qpc = chroma_qp(qp, self.pp.chroma_qp_index_offset)
        qp_i = idr_qp(qp) if len(frames) > 1 else qp
        qpc_i = chroma_qp(qp_i, self.pp.chroma_qp_index_offset)
        sr = search_range_for_effort(cfg.effort)
        lam = lam_for_qp(qp)
        n_mby, n_mbx = self.sp.mb_height, self.sp.mb_width
        n_mb = n_mby * n_mbx
        h16, w16 = 16 * n_mby, 16 * n_mbx
        delta = self._use_delta()
        if delta:
            prev_tiles, src = self._delta_carry(n_mb)

        # Phase 1: dispatch the IDR and every P chunk; the chunks chain on
        # the IDR's device-resident recon.
        t0 = time.perf_counter()
        rd_intra = cfg.use_rd_intra()
        pads = self._pad(*frames[0])
        if delta and src is not None and not rd_intra:
            # the IDR as a delta against the carried source
            idx, tiles = self._upload_delta(
                [self._tile_delta(pads, prev_tiles)], n_mb)
            imeta, icount, iblocks, *src, ry, ru, rv = \
                gop_ops.encode_iframe_delta(*src, idx[0], tiles[0], qp_i,
                                            qpc_i, h16, w16, cfg.deblock)
            recon = (ry, ru, rv)
        else:
            planes = [self._upload(p) for p in pads]
            if delta:
                self._tile_delta(pads, prev_tiles, full=True)
                src = gop_ops.source_tiles(*planes, h16, w16)
            if rd_intra:
                # quality shape: dense RD-mode intra (per-MB mode choice);
                # one IDR per GOP, so the dense fetch is amortized
                iout, ikeys = self._rd_iframe(planes, qp_i, qpc_i)
                recon = (iout["recon_y"], iout["recon_u"], iout["recon_v"])
            else:
                imeta, icount, iblocks, *recon = \
                    gop_ops.encode_iframe_sparse(*planes, qp_i, qpc_i,
                                                 cfg.deblock)
                recon = tuple(recon)
        self.idr_count += 1
        self._frame_num = 1
        t1 = time.perf_counter()
        self.stage_s["idr"] += t1 - t0

        pending = []
        i = 1
        while i < len(frames):
            chunk = next(c for c in self.P_CHUNKS if c <= len(frames) - i)
            pads = [self._pad(*frames[i + k]) for k in range(chunk)]
            if delta:
                idx, tiles = self._upload_delta(
                    [self._tile_delta(p, prev_tiles) for p in pads], n_mb)
                bitmap, counts, meta, payload, *src, ry, ru, rv = \
                    gop_ops.encode_pchunk_delta(
                        *src, idx, tiles, *recon, qp, qpc, sr, lam, h16,
                        w16, cfg.deblock, subpel_for_effort(cfg.effort),
                        cfg.transform8)
            else:
                tp = time.perf_counter()
                buf = gop_ops.pack_frames(pads)
                self._pack_s += time.perf_counter() - tp
                bitmap, counts, meta, payload, ry, ru, rv = \
                    gop_ops.encode_pchunk_sparse(
                        self._upload(buf), *recon, qp, qpc, sr, lam, h16,
                        w16, cfg.deblock, subpel_for_effort(cfg.effort),
                        cfg.transform8)
            recon = tuple(p.to(torch.uint8) for p in (ry, ru, rv))
            mcap = min(self._mcap, meta.shape[0])
            pcap = min(self._pcap, payload.shape[0])
            pending.append((chunk, self._fetch_async(gop_ops.combine_fetch(
                bitmap, counts, meta, payload, mcap, pcap)), meta, payload,
                mcap, pcap))
            i += chunk
        self._recon = recon
        if delta:
            self._prev_tiles, self._src_dev = prev_tiles, tuple(src)
        t0, t1 = t1, time.perf_counter()
        self.stage_s["p"] += t1 - t0

        # Phase 2: fetch + host entropy, IDR first.
        out: list[tuple[bytes, bool]] = []
        if rd_intra:
            idata = {k: iout[k].cpu().numpy() for k in ikeys}
            t2 = time.perf_counter()
        else:
            icnt = int(icount[0])
            imeta_h = imeta.cpu().numpy()
            iblocks_h = iblocks[:icnt].cpu().numpy()
            t2 = time.perf_counter()
            idata = gop_ops.unpack_sparse_iframe(imeta_h, iblocks_h, icnt,
                                                 n_mbx)
        self.stage_s["fetch"] += t2 - t1
        out.append((entropy.write_islice(
            self.sp, self.pp, frame_num=0,
            idr_pic_id=(self.idr_count - 1) % 65536, qp=qp_i, data=idata,
            deblock=cfg.deblock, poc_lsb=0), True))
        self.stage_s["entropy"] += time.perf_counter() - t2
        for chunk, token, meta, payload, mcap, pcap in pending:
            t1 = time.perf_counter()
            mcount, bcount, bitmap_h, meta_h, pay_h = gop_ops.split_fetch(
                self._fetched(token), chunk, n_mb, mcap, pcap)
            if mcount > mcap or bcount > pcap:
                meta_h, pay_h = self._fetch_tail(meta, payload, meta_h,
                                                 pay_h, mcount, bcount)
            t2 = time.perf_counter()
            self.stage_s["fetch"] += t2 - t1
            for data in gop_ops.unpack_sparse_chunk(
                    bitmap_h, meta_h, pay_h, mcount, bcount, n_mby, n_mbx):
                out.append((entropy.write_pslice(
                    self.sp, self.pp, frame_num=self._frame_num, qp=qp,
                    data=data, deblock=cfg.deblock,
                    poc_lsb=2 * len(out)), False))
                self._frame_num += 1
            self.stage_s["entropy"] += time.perf_counter() - t2
        self.frame_index += len(frames)
        if self.rc:
            self.rc.update(len(frames), sum(len(nal) for nal, _ in out))
        return out

    def _fetch_tail(self, meta, payload, meta_h, pay_h, mcount: int,
                    bcount: int):
        """A P chunk whose counts passed the sticky caps: the rows past
        them, each up to a fetch bucket, in ONE copy; then the caps grow
        (twice the count, bucketed, at most 2^15 rows) so that later
        chunks fetch in one buffer. Returns the whole (meta, payload)."""
        mcap, pcap = len(meta_h), len(pay_h)
        mend = gop_ops.fetch_bucket(mcount, meta.shape[0], base=mcap) \
            if mcount > mcap else mcap
        pend = gop_ops.fetch_bucket(bcount, payload.shape[0], base=pcap) \
            if bcount > pcap else pcap
        tail = torch.cat([meta[mcap:mend].reshape(-1),
                          payload[pcap:pend].reshape(-1)]).cpu().numpy()
        nm = (mend - mcap) * meta.shape[1]
        meta_h = np.concatenate([meta_h, tail[:nm].reshape(-1,
                                                           meta.shape[1])])
        pay_h = np.concatenate([pay_h, tail[nm:].reshape(-1,
                                                         payload.shape[1])])
        if mcount > mcap:
            self._mcap = min(gop_ops.fetch_bucket(
                2 * mcount, meta.shape[0], base=256), 1 << 15)
        if bcount > pcap:
            self._pcap = min(gop_ops.fetch_bucket(
                2 * bcount, payload.shape[0], base=256), 1 << 15)
        return meta_h, pay_h

    LEVEL_KEYS = ("luma_dc", "luma_ac", "cb_dc", "cb_ac", "cr_dc", "cr_ac")

    def _rd_iframe(self, planes, qp_i: int, qpc_i: int):
        """The RD intra IDR on the device: I16 or I_NxN / i8 per MB when
        the stream is High-profile CABAC, else I16 only. Returns (device
        dict, entropy keys)."""
        from . import intra_rd
        cfg = self.cfg
        if cfg.transform8 and cfg.cabac:
            return (intra_rd.encode_iframe_rd8(*planes, qp_i, qpc_i,
                                               cfg.deblock),
                    self.LEVEL_KEYS + ("modes", "cmodes", "i8", "i8_modes",
                                       "i8_luma"))
        return (intra_rd.encode_iframe_rd(*planes, qp_i, qpc_i, cfg.deblock),
                self.LEVEL_KEYS + ("modes", "cmodes"))

    def _rd_or_row_iframe(self, planes, qp_i: int, qpc_i: int):
        """Dense IDR on the device: the RD intra frame when RD intra is
        on, else the row-pattern I16 frame. Returns (device dict, entropy
        keys)."""
        if self.cfg.use_rd_intra():
            return self._rd_iframe(planes, qp_i, qpc_i)
        from .frame_ops import encode_iframe
        return (encode_iframe(*planes, qp_i, qpc_i, self.cfg.deblock),
                self.LEVEL_KEYS)

    INTRA_P_KEYS = ("intra", "i8", "imodes", "icmodes", "luma_dc",
                    "i8_modes")

    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     force_idr: bool = False) -> tuple[bytes, bool]:
        """Encode one frame without B pictures: an IDR at every
        ``cfg.gop_size``-th frame (or when ``force_idr``), else a P
        picture from the last recon, each through one device step and one
        slice writer (no rate control: ``cfg.qp``). Returns (Annex-B
        access unit, is_idr)."""
        cfg = self.cfg
        if cfg.bframes > 0:
            raise ValueError("per-frame encode path does not support "
                             "B frames; use encode_gop/encode_stream")
        is_idr = force_idr or self.frame_index % cfg.gop_size == 0 \
            or self._recon is None
        planes = [self._upload(p) for p in self._pad(y, u, v)]
        off = self.pp.chroma_qp_index_offset
        if is_idr:
            qp_i = idr_qp(cfg.qp) if cfg.gop_size > 1 else cfg.qp
            out, keys = self._rd_or_row_iframe(planes, qp_i,
                                               chroma_qp(qp_i, off))
            nal = entropy.write_islice(
                self.sp, self.pp, frame_num=0,
                idr_pic_id=self.idr_count % 65536, qp=qp_i,
                data={k: out[k].cpu().numpy() for k in keys},
                deblock=cfg.deblock)
            self.idr_count += 1
            self._frame_num = 1
        else:
            out, nal = self._encode_pframe(planes, cfg.qp,
                                           chroma_qp(cfg.qp, off))
            self._frame_num += 1
        self._recon = (out["recon_y"], out["recon_u"], out["recon_v"])
        self.frame_index += 1
        # the per-frame path keeps no device source: a later encode_gop
        # starts the delta carry anew with a whole frame
        self._prev_tiles = self._src_dev = None
        return nal, is_idr

    def _encode_pframe(self, planes, qp: int, qpc: int):
        """One P picture of ``encode_frame``: (device dict, slice NAL)."""
        from . import pframe
        cfg = self.cfg
        out = pframe.encode_pframe(
            *planes, *self._recon, qp, qpc,
            search_range=search_range_for_effort(cfg.effort),
            deblock=cfg.deblock, subpel=subpel_for_effort(cfg.effort),
            t8=cfg.transform8, parts=cfg.parts,
            intra_mbs=cfg.use_intra_p())
        keys = ["mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac"]
        if cfg.transform8:
            keys.append("t8")
        if cfg.parts:
            keys += ["mv8", "parts"]
        if "intra" in out:
            keys += self.INTRA_P_KEYS
        data = {k: out[k].cpu().numpy() for k in keys}
        self._last_p_data = data
        return out, entropy.write_pslice(
            self.sp, self.pp, frame_num=self._frame_num, qp=qp, data=data,
            deblock=cfg.deblock)

    def _encode_gop_b(self, frames: list) -> list[tuple]:
        """IDR + P anchors every bframes+1 display positions + non-reference
        B pictures between them, in decode order (I, P1, B.., P2, B..;
        libx264 -bf N with b-adapt 0 and no B pyramid). Returns (nal,
        is_idr, cts_offset) triples, cts_offset = display - decode + 1 in
        frames.

        Phase 1 dispatches the whole decode-order device chain, packing
        each frame's entropy inputs into one flat int16 buffer on the
        device (with ``VCP_SPARSE_B`` on, the default, only its nonzero
        16-word chunks, ``gop_ops.sparsify_buf``, with a sticky cap per
        buffer kind) and starting its copy to the host; the source frames
        go up in decode order as delta tiles over the shared carry. Phase
        2 reads each buffer once and runs the slice writers in order."""
        from . import bframe, pframe
        cfg = self.cfg
        qp = self.rc.gop_qp() if self.rc else cfg.qp
        # B pictures are non-reference: a deeper QP offset
        qp_b = min(51, qp + int(os.environ.get("VCP_QPB_OFFSET", "4")))
        qp_i = idr_qp(qp)
        off = self.pp.chroma_qp_index_offset
        qpc, qpc_b, qpc_i = (chroma_qp(q, off) for q in (qp, qp_b, qp_i))
        sr = search_range_for_effort(cfg.effort)
        # anchors span bframes+1 display frames of motion: a wider window
        # (capped; the search is O(sr^2))
        sr_a = min(24, sr * (cfg.bframes + 1))
        subpel = subpel_for_effort(cfg.effort)
        intra_p = cfg.use_intra_p()
        b, n = cfg.bframes, len(frames)
        nby, nbx = self.sp.mb_height, self.sp.mb_width
        anchors = list(range(0, n, b + 1))
        if anchors[-1] != n - 1:
            anchors.append(n - 1)

        # per-frame packed layouts; every field fits int16 (levels peak
        # near 8.6k for 8x8 at QP 0, MVs are bounded by the search window)
        pfields = [("luma", (nby, nbx, 16, 16)), ("cb_dc", (nby, nbx, 4)),
                   ("cb_ac", (nby, nbx, 4, 16)), ("cr_dc", (nby, nbx, 4)),
                   ("cr_ac", (nby, nbx, 4, 16))]
        if cfg.parts:
            pfields += [("mv8", (2 * nby, 2 * nbx, 2)), ("parts", (nby, nbx))]
        else:
            pfields += [("mv", (nby, nbx, 2))]
        if cfg.transform8:
            pfields += [("t8", (nby, nbx))]
        if intra_p:
            pfields += [("intra", (nby, nbx)), ("i8", (nby, nbx)),
                        ("imodes", (nby, nbx)), ("icmodes", (nby, nbx)),
                        ("luma_dc", (nby, nbx, 16)),
                        ("i8_modes", (nby, nbx, 4))]
        bfields = [("mv0", (nby, nbx, 2)), ("mv1", (nby, nbx, 2)),
                   ("mode", (nby, nbx))] + pfields[:5]

        sparse = os.environ.get("VCP_SPARSE_B", "1") != "0"
        spcaps = self._spcaps

        def pack(o, fields, key):
            buf = torch.cat([o[k].to(torch.int16).reshape(-1)
                             for k, _ in fields])
            if not sparse:
                return self._fetch_async(buf), None, 0, fields, key, 0
            cap = spcaps.setdefault(key, 2048)
            comb, comp = gop_ops.sparsify_buf(buf, cap)
            return (self._fetch_async(comb), comp, buf.shape[0], fields, key,
                    cap)

        def unpack(buf, fields):
            data, at = {}, 0
            for k, shape in fields:
                cnt = int(np.prod(shape))
                data[k] = buf[at:at + cnt].astype(np.int32).reshape(shape)
                at += cnt
            return data

        delta = self._use_delta()
        h16, w16, n_mb = 16 * nby, 16 * nbx, nby * nbx
        if delta:
            prev_tiles, src = self._delta_carry(n_mb)

        def upload(fi):
            """Source frame ``fi`` as padded planes on the device: with
            the delta upload its changed tiles applied to the carry (the
            whole frame when there is no carry yet)."""
            nonlocal src
            pads = self._pad(*frames[fi])
            if not delta or src is None:
                planes = [self._upload(p) for p in pads]
                if delta:
                    self._tile_delta(pads, prev_tiles, full=True)
                    src = gop_ops.source_tiles(*planes, h16, w16)
                return planes
            idx, tiles = self._upload_delta(
                [self._tile_delta(pads, prev_tiles)], n_mb)
            *src, y, u, v = gop_ops.delta_planes(*src, idx[0], tiles[0],
                                                 h16, w16)
            return y, u, v

        # ---- phase 1: dispatch the IDR, the anchors and the Bs ----
        t0 = time.perf_counter()
        iout, ikeys = self._rd_or_row_iframe(upload(0), qp_i, qpc_i)
        ifields = [(k, tuple(iout[k].shape)) for k in ikeys]
        itok = pack(iout, ifields, "i")
        prev_a = 0
        prev_recon = (iout["recon_y"], iout["recon_u"], iout["recon_v"])
        t1 = time.perf_counter()
        self.stage_s["idr"] += t1 - t0
        segs = []
        for k, a in enumerate(anchors[1:], start=1):
            t0 = time.perf_counter()
            pout = pframe.encode_pframe(
                *upload(a), *prev_recon, qp, qpc, search_range=sr_a,
                deblock=cfg.deblock, subpel=subpel, t8=cfg.transform8,
                parts=cfg.parts, intra_mbs=intra_p)
            ptok = pack(pout, pfields, "p")
            cur_recon = (pout["recon_y"], pout["recon_u"], pout["recon_v"])
            t1 = time.perf_counter()
            self.stage_s["p"] += t1 - t0
            btoks = [pack(gop_ops.encode_bframe(
                *upload(d), *prev_recon, *cur_recon, qp_b, qpc_b, sr,
                lam_for_qp(qp_b), subpel, cfg.deblock), bfields, "b")
                for d in range(prev_a + 1, a)]
            self.stage_s["b"] += time.perf_counter() - t1
            segs.append((k, a, prev_a, ptok, btoks))
            prev_a, prev_recon = a, cur_recon

        # ---- phase 2: fetch + host entropy, decode order ----
        out: list[tuple] = []

        def fetch(tok):
            token, comp, n, fields, key, cap = tok
            t = time.perf_counter()
            buf = self._fetched(token)
            if sparse:
                buf, count = gop_ops.unsparsify_buf(buf, n, cap, comp)
                if count > cap:
                    # grow the sticky cap so that later GOPs fetch in one
                    nc = (n + gop_ops.SP_K - 1) // gop_ops.SP_K
                    spcaps[key] = min(gop_ops.fetch_bucket(
                        2 * count, nc, base=2048), nc)
            self.stage_s["fetch"] += time.perf_counter() - t
            return unpack(buf, fields)

        def emit(nal, is_idr, disp):
            # the decode index of this sample is len(out)
            out.append((nal, is_idr, disp - len(out) + 1))

        idata = fetch(itok)
        t = time.perf_counter()
        emit(entropy.write_islice(
            self.sp, self.pp, frame_num=0,
            idr_pic_id=self.idr_count % 65536, qp=qp_i, data=idata,
            deblock=cfg.deblock, poc_lsb=0), True, 0)
        self.idr_count += 1
        self.stage_s["entropy"] += time.perf_counter() - t

        for k, a, seg_prev, ptok, btoks in segs:
            pdata = fetch(ptok)
            t = time.perf_counter()
            if cfg.parts:
                pdata["mv"] = pdata["mv8"][::2, ::2]
            emit(entropy.write_pslice(
                self.sp, self.pp, frame_num=k, qp=qp, data=pdata,
                deblock=cfg.deblock, poc_lsb=2 * a), False, a)
            col_zero, col_safe = _colocated(pdata, cfg.parts, intra_p)
            self.stage_s["entropy"] += time.perf_counter() - t
            for i, d in enumerate(range(seg_prev + 1, a)):
                bdata = fetch(btoks[i])
                t = time.perf_counter()
                bdata["col_zero"] = col_zero
                if col_safe is not None:
                    bdata["col_safe"] = col_safe
                emit(bframe.write_bslice(
                    self.sp, self.pp, frame_num=k + 1, qp=qp_b, data=bdata,
                    deblock=cfg.deblock, poc_lsb=2 * d), False, d)
                self.stage_s["entropy"] += time.perf_counter() - t

        self._recon = prev_recon
        self._frame_num = len(anchors)
        self.frame_index += n
        # the next GOP's first frame deltas against this GOP's last upload
        self._prev_tiles, self._src_dev = \
            (prev_tiles, tuple(src)) if delta else (None, None)
        if self.rc:
            self.rc.update(n, sum(len(s[0]) for s in out))
        return out

    @property
    def recon_planes(self):
        """Last reconstructed (unpadded) planes as numpy, for PSNR."""
        if self._recon is None:
            return None
        y, u, v = (p.cpu().numpy() for p in self._recon)
        return (y[: self.cfg.height, : self.cfg.width],
                u[: self.cfg.height // 2, : self.cfg.width // 2],
                v[: self.cfg.height // 2, : self.cfg.width // 2])


def _colocated(pdata: dict, parts: bool, intra_p: bool):
    """(col_zero, col_safe) of a future anchor (RefPicList1[0]) for the B
    slices' spatial-direct derivation: colZeroFlag of an inter MB whose
    vector is within +-1 quarter-pel. With partitioned anchors colZero
    is per 8x8 block: the MB grid is all-four-zero, and col_safe masks
    out the MBs whose four blocks disagree (no B_Skip there, the spec
    derivation would split inside the MB); intra blocks are never
    colZero. col_safe is None for anchors without partitions."""
    if not parts:
        return (np.abs(pdata["mv"]) <= 1).all(-1), None
    z8 = (np.abs(pdata["mv8"]) <= 1).all(-1)
    if intra_p:
        z8 &= ~np.repeat(np.repeat(pdata["intra"].astype(bool), 2, 0), 2, 1)
    nby, nbx = pdata["parts"].shape
    zq = z8.reshape(nby, 2, nbx, 2)
    col_zero = zq.all(axis=(1, 3))
    return col_zero, col_zero | ~zq.any(axis=(1, 3))


SCENE_CUT_THRESHOLD = 28.0   # mean abs luma diff (8x-downsampled)


def _is_scene_cut(prev_y: np.ndarray, cur_y: np.ndarray) -> bool:
    """Host-side cut detector: mean |Δluma| on an 8x subsample; a cut
    starts a new GOP so the IDR lands on the content change."""
    a = prev_y[::8, ::8].astype(np.int32)
    b = cur_y[::8, ::8].astype(np.int32)
    return float(np.abs(a - b).mean()) > SCENE_CUT_THRESHOLD


def encode_stream(frames, cfg: EncoderConfig, deadline: float | None = None,
                  on_frame=None, device: str = "cuda"):
    """Encode an iterable of (y, u, v) uint8 planes → (sps, pps, samples)
    with samples [(annexb_au, is_idr)], or (annexb_au, is_idr,
    cts_offset) in streams with B pictures. Frames are grouped into GOPs at
    ``cfg.gop_size`` and at scene cuts; the deadline is checked between
    GOPs. The host seconds spent pulling frames from ``frames`` count
    as the encoder's ``stage_s["decode"]``.

    Profiling: with ``VCP_TRACE_DIR=<dir>`` the whole encode runs under
    ``torch.profiler`` (host operators, and the card's kernels and copies
    on ``cuda``) and Kineto's JSON trace is written into ``dir``
    (chrome://tracing, Perfetto)."""
    trace_dir = os.environ.get("VCP_TRACE_DIR")
    if not trace_dir:
        return _encode_stream_inner(frames, cfg, deadline, on_frame, device)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        result = _encode_stream_inner(frames, cfg, deadline, on_frame, device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"vcp_h264_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("trace written", path=path)
    return result


def _encode_stream_inner(frames, cfg: EncoderConfig, deadline, on_frame,
                         device):
    enc = H264Encoder(cfg, device=device)
    samples = []
    gop: list = []
    frames = iter(frames)

    def flush():
        if not gop:
            return
        if deadline is not None and time.monotonic() > deadline:
            raise EncodeAbort(f"deadline exceeded at frame {len(samples)}")
        samples.extend(enc.encode_gop(gop))
        gop.clear()
        if on_frame:
            on_frame(len(samples) - 1, enc)

    while True:
        t0 = time.perf_counter()
        f = next(frames, None)
        enc.stage_s["decode"] += time.perf_counter() - t0
        if f is None:
            break
        if gop and _is_scene_cut(gop[-1][0], f[0]):
            flush()
        gop.append(f)
        if len(gop) >= cfg.gop_size:
            flush()
    flush()
    sps, pps = enc.sps_pps_raw()
    return sps, pps, samples


def mux_mp4(path: str, sps: bytes, pps: bytes, samples, width: int,
            height: int, fps_num: int, fps_den: int,
            faststart: bool = True, audio_track=None) -> None:
    w = mp4mod.Mp4Writer()
    dur = fps_den * 1000
    tr = mp4mod.VideoTrack(codec="h264", width=width, height=height,
                           timescale=fps_num * 1000, sps=[sps], pps=[pps])
    for s in samples:
        cts = s[2] if len(s) > 2 else 0   # frames; B streams carry 3-tuples
        tr.samples.append(mp4mod.Sample(
            data=mp4mod.annexb_to_length_prefixed(s[0]),
            duration=dur, is_sync=s[1], cts_offset=cts * dur))
    w.add_track(tr)
    if audio_track is not None and audio_track.samples:
        w.add_track(audio_track)
    w.write(path, faststart=faststart)


def resolve_scale(sw: int, sh: int, src_w: int, src_h: int):
    """Resolve an ffmpeg-style scale target against the source size:
    (height, width), or None for no scaling. ``-1`` / ``-2`` keep the
    source aspect ratio, rounded to even (4:2:0 needs even planes)."""
    if not sw and not sh:
        return None
    if sw in (-1, -2) and sh in (-1, -2):
        raise ValueError("scale: width and height cannot both be -1/-2")
    if sw in (-1, -2):
        sw = max(2, int(round(src_w * sh / src_h / 2)) * 2)
    elif sh in (-1, -2):
        sh = max(2, int(round(src_h * sw / src_w / 2)) * 2)
    if sw <= 0 or sh <= 0:
        raise ValueError(f"scale: bad target {sw}x{sh}")
    return (sh, sw)


def encode_file(input_path: str, output_path: str, params: EncodeParams,
                deadline: float | None = None, device: str = "cuda") -> int:
    """Encode a .y4m, or an H.264 .mp4 / .mkv / .avi file, to MP4 on
    ``device``; returns the output size. Inputs are decoded on the host
    (``codec.ingest``); ``-s`` / ``-vf scale`` resizes each frame on
    ``device``; under ``-c:a aac|copy`` without ``-an`` the input's audio
    goes into the MP4 (``codec.audio.audio_track_for``), and an audio
    track that fails is logged and left out, as in ``vcp_tpu``."""
    from ..ingest import open_video
    vid = open_video(input_path)
    w, h = vid.width, vid.height
    tgt = resolve_scale(params.scale_width, params.scale_height, w, h)
    cfg = EncoderConfig.from_params(params, width=tgt[1] if tgt else w,
                                    height=tgt[0] if tgt else h,
                                    fps_num=vid.fps_num, fps_den=vid.fps_den)
    t0 = time.monotonic()

    def frames():
        for y, u, v in vid.frames:
            if tgt is not None:
                y, u, v = scale_yuv420(y, u, v, tgt[0], tgt[1], device)
            yield y, u, v

    sps, pps, samples = encode_stream(frames(), cfg, deadline, device=device)
    audio_track = None
    if params.audio_codec in ("aac", "copy") and not params.audio_disabled:
        from ..audio import audio_track_for
        try:
            audio_track = audio_track_for(input_path, params)
        except Exception as e:
            log.warn("audio passthrough failed", error=str(e))
    mux_mp4(output_path, sps, pps, samples, cfg.width, cfg.height,
            cfg.fps_num, cfg.fps_den, faststart=params.faststart,
            audio_track=audio_track)
    dt = time.monotonic() - t0
    size = os.path.getsize(output_path)
    log.info("encode done", frames=len(samples), qp=cfg.qp,
             fps=f"{len(samples) / max(dt, 1e-9):.1f}", size=size)
    return size
