"""H.265/HEVC encoder: device math + host CABAC + mux.

Port of ``vcp_tpu/codec/h265/encoder.py``, which serves the
``h265-nvenc`` (effort 4), ``h265-cpu`` (libx265 medium, effort 5) and
``h265-nvenc-hq`` (effort 7) presets:

* device (``frame_ops``, ``intra_rd``): CTU intra / inter prediction,
  the 32 / 16 transforms, quantization and the closed-loop
  reconstruction, which stays on the device across the GOP; only levels,
  intra modes and vectors are fetched;
* host: CABAC slice syntax (``syntax`` / ``residual``, pure Python), NAL
  framing (``headers``) and the ``hvc1`` MP4 (``codec.mp4``).

The IDR is the row-pattern intra frame below effort 5 and the RD
wavefront (``intra_rd``) from effort 5 on, or as ``VCP_HEVC_RDI`` says;
every P frame searches full-pel at the effort's range and refines to
quarter-pel. Frames pad to 32-px CTU multiples with an SPS conformance
window cropping back to the true size. There are no B pictures.
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
from ...ops.transform_hevc import chroma_qp
from ...utils.bitstream import BitWriter
from ..args import EncodeParams
from . import frame_ops, headers, intra_rd, syntax

log = new_logger("h265")


class EncodeAbort(RuntimeError):
    pass


@dataclasses.dataclass
class HevcEncoderConfig:
    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    qp: int = 32
    gop_size: int = 30
    effort: int = 4
    rd_intra: bool | None = None   # per-CTU RD mode selection over the
                                   # full MODESET (None = auto: quality
                                   # presets, effort >= 5)
    params: EncodeParams | None = None

    def use_rd_intra(self) -> bool:
        if os.environ.get("VCP_HEVC_RDI"):
            return os.environ["VCP_HEVC_RDI"] != "0"
        if self.rd_intra is not None:
            return self.rd_intra
        return self.effort >= 5

    @classmethod
    def from_params(cls, params: EncodeParams, width: int, height: int,
                    fps_num: int, fps_den: int) -> "HevcEncoderConfig":
        cfg = cls(width=width, height=height, fps_num=fps_num,
                  fps_den=fps_den, effort=params.effort)
        if params.gop_size:
            cfg.gop_size = params.gop_size
        else:
            fps = fps_num / max(1, fps_den)
            cfg.gop_size = max(1, int(round(fps)))
        from ..h264.ratecontrol import initial_qp
        cfg.qp = min(51, initial_qp(params, width, height,
                                    fps_num / max(1, fps_den)))
        cfg.params = params
        return cfg


def _pad_plane(p: np.ndarray, mult: int) -> np.ndarray:
    h, w = p.shape
    ph = (-h) % mult
    pw = (-w) % mult
    if not ph and not pw:
        return np.ascontiguousarray(p)
    return np.pad(p, ((0, ph), (0, pw)), mode="edge")


def search_range_for_effort(effort: int) -> int:
    return {1: 4, 2: 4, 3: 6, 4: 8, 5: 12, 6: 12, 7: 16}.get(
        min(max(effort, 1), 7), 8)


class HevcEncoder:
    """Stateful per-task encoder: feeds frames, emits Annex-B access
    units. ``device`` defaults to ``"cuda"`` (raises without a card);
    pass ``"cpu"`` to run the same tensor code on the CPU."""

    def __init__(self, cfg: HevcEncoderConfig, device: str = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        pw = cfg.width + ((-cfg.width) % 32)
        ph = cfg.height + ((-cfg.height) % 32)
        self.hp = headers.HevcParams(
            width=pw, height=ph, qp=cfg.qp, log2_ctu=5,
            conf_win_right=pw - cfg.width,
            conf_win_bottom=ph - cfg.height)
        self.frame_index = 0
        self.poc = 0
        self._gop_qp = cfg.qp
        self._recon = None          # (y, u, v) int32 planes on the device
        # host seconds per stage, summed over frames: decode (pulling the
        # frames from the input; ``encode_stream`` adds it), the IDRs' and
        # the P frames' dispatch (pad, upload, enqueue device work), fetch
        # (device->host copies, which wait for the device) and entropy
        # (CABAC slice data, header and NAL framing)
        self.stage_s = {"decode": 0.0, "idr": 0.0, "p": 0.0, "fetch": 0.0,
                        "entropy": 0.0}
        self.rc = None
        if cfg.params is not None and cfg.params.rate_mode() == "abr":
            from ..h264.ratecontrol import RateController
            self.rc = RateController(cfg.params, cfg.width, cfg.height,
                                     cfg.fps_num / max(1, cfg.fps_den))

    def resume(self, st) -> None:
        """Continue a GOP from ``st`` (a ``state.HevcState``, e.g. from
        ``vcp_tpu``'s encoder): its recon is the reference of the next P
        frame, its QP the GOP's, its POC the next frame's."""
        self._recon = st.recon
        self._gop_qp = st.qp
        self.poc = self.frame_index = st.poc

    # -- parameter sets ---------------------------------------------------
    def headers_annexb(self) -> bytes:
        return (headers.write_vps(self.hp) + headers.write_sps(self.hp)
                + headers.write_pps(self.hp))

    def param_sets_raw(self):
        """(vps, sps, pps) NAL payloads incl. 2-byte NAL header (hvcC)."""
        return (headers.write_vps(self.hp)[4:],
                headers.write_sps(self.hp)[4:],
                headers.write_pps(self.hp)[4:])

    def _upload(self, y, u, v):
        """Pad on the host, upload the uint8 planes, widen on the device."""
        return tuple(
            torch.from_numpy(_pad_plane(np.asarray(p, np.uint8), m))
            .to(self.device).to(torch.int32)
            for p, m in ((y, 32), (u, 16), (v, 16)))

    def encode_frame(self, y, u, v, force_idr: bool = False):
        """Encode one frame; returns (annexb AU, is_idr)."""
        cfg = self.cfg
        t0 = time.perf_counter()
        is_idr = (force_idr or self._recon is None
                  or self.frame_index % cfg.gop_size == 0)
        qp = self.rc.gop_qp() if (self.rc and is_idr) else self._gop_qp
        if is_idr:
            self._gop_qp = qp
        qpc = chroma_qp(qp)
        yp, up, vp = self._upload(y, u, v)
        if is_idr:
            if cfg.use_rd_intra():
                out = intra_rd.encode_iframe_rd(yp, up, vp, qp, qpc)
            else:
                out = frame_ops.encode_iframe(yp, up, vp, qp, qpc)
            self.poc = 0
        else:
            sr = search_range_for_effort(cfg.effort)
            lam = max(1, (qp - 12) // 3)
            out = frame_ops.encode_pframe(
                yp, up, vp, *self._recon, qp, qpc, sr, lam)
        self._recon = (out["recon_y"], out["recon_u"], out["recon_v"])
        t1 = time.perf_counter()
        self.stage_s["idr" if is_idr else "p"] += t1 - t0

        levels_y, levels_u, levels_v = (
            out[k].cpu().numpy().astype(np.int32)
            for k in ("levels_y", "levels_u", "levels_v"))
        imodes = out["modes"].cpu().numpy() if is_idr else None
        mv = None if is_idr else out["mv"].cpu().numpy()
        t2 = time.perf_counter()
        self.stage_s["fetch"] += t2 - t1

        payload = syntax.encode_slice_data(qp, is_idr, levels_y,
                                           levels_u, levels_v, mv,
                                           modes=imodes)
        bw = BitWriter()
        headers.write_slice_header(bw, self.hp, is_idr=is_idr,
                                   poc_lsb=self.poc & 0xFF, slice_qp=qp)
        nal_type = headers.NAL_IDR_W_RADL if is_idr else headers.NAL_TRAIL_R
        nal = headers.hevc_nal(nal_type, bw.to_bytes() + payload)
        self.stage_s["entropy"] += time.perf_counter() - t2
        self.frame_index += 1
        self.poc += 1
        if self.rc:
            self.rc.update(1, len(nal))
        return nal, is_idr

    @property
    def recon_planes(self):
        if self._recon is None:
            return None
        y, u, v = (p.cpu().numpy() for p in self._recon)
        return (y[: self.cfg.height, : self.cfg.width],
                u[: self.cfg.height // 2, : self.cfg.width // 2],
                v[: self.cfg.height // 2, : self.cfg.width // 2])


def encode_stream(frames, cfg: HevcEncoderConfig,
                  deadline: float | None = None, device: str = "cuda"):
    """Iterable of (y, u, v) uint8 planes -> (vps, sps, pps, samples)
    with samples [(annexb AU, is_idr)]; a scene cut forces an IDR. The
    host seconds spent pulling frames count as ``stage_s["decode"]``."""
    from ..h264.encoder import _is_scene_cut
    enc = HevcEncoder(cfg, device=device)
    samples = []
    prev_y = None
    frames = iter(frames)
    while True:
        t0 = time.perf_counter()
        f = next(frames, None)
        enc.stage_s["decode"] += time.perf_counter() - t0
        if f is None:
            break
        if deadline is not None and time.monotonic() > deadline:
            raise EncodeAbort(f"deadline exceeded at frame {len(samples)}")
        cut = prev_y is not None and _is_scene_cut(prev_y, f[0])
        samples.append(enc.encode_frame(*f, force_idr=cut))
        prev_y = f[0]
    vps, sps, pps = enc.param_sets_raw()
    return vps, sps, pps, samples


def mux_mp4(path: str, vps: bytes, sps: bytes, pps: bytes, samples,
            width: int, height: int, fps_num: int, fps_den: int,
            faststart: bool = True, audio_track=None) -> None:
    w = mp4mod.Mp4Writer()
    dur = fps_den * 1000
    tr = mp4mod.VideoTrack(codec="h265", width=width, height=height,
                           timescale=fps_num * 1000, vps=[vps], sps=[sps],
                           pps=[pps])
    for au, is_idr in samples:
        tr.samples.append(mp4mod.Sample(
            data=mp4mod.annexb_to_length_prefixed(au),
            duration=dur, is_sync=is_idr))
    w.add_track(tr)
    if audio_track is not None and audio_track.samples:
        w.add_track(audio_track)
    w.write(path, faststart=faststart)


def encode_file(input_path: str, output_path: str, params: EncodeParams,
                deadline: float | None = None, device: str = "cuda") -> int:
    """Encode a .y4m, or an H.264 / HEVC .mp4, .mkv or .avi file, to
    HEVC-in-MP4 on ``device``; returns the output size. Inputs are
    decoded on the host (``codec.ingest``), ``-s`` / ``-vf scale``
    resizes on ``device``, and the input's audio is muxed as for H.264
    (``codec.audio.audio_track_for``; a track that fails is logged and
    left out, as in ``vcp_tpu``)."""
    from ..h264.encoder import resolve_scale
    from ..ingest import open_video
    vid = open_video(input_path)
    w, h = vid.width, vid.height
    tgt = resolve_scale(params.scale_width, params.scale_height, w, h)
    cfg = HevcEncoderConfig.from_params(
        params, width=tgt[1] if tgt else w, height=tgt[0] if tgt else h,
        fps_num=vid.fps_num, fps_den=vid.fps_den)
    t0 = time.monotonic()

    def frames():
        for y, u, v in vid.frames:
            if tgt is not None:
                y, u, v = scale_yuv420(y, u, v, tgt[0], tgt[1], device)
            yield y, u, v

    vps, sps, pps, samples = encode_stream(frames(), cfg, deadline,
                                           device=device)
    audio_track = None
    if params.audio_codec in ("aac", "copy") and not params.audio_disabled:
        from ..audio import audio_track_for
        try:
            audio_track = audio_track_for(input_path, params)
        except Exception as e:
            log.warn("audio passthrough failed", error=str(e))
    mux_mp4(output_path, vps, sps, pps, samples, cfg.width, cfg.height,
            cfg.fps_num, cfg.fps_den, faststart=params.faststart,
            audio_track=audio_track)
    dt = time.monotonic() - t0
    size = os.path.getsize(output_path)
    log.info("encode done", frames=len(samples), qp=cfg.qp,
             fps=f"{len(samples) / max(dt, 1e-9):.1f}", size=size)
    return size
