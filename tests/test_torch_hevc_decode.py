"""The port's HEVC decoders against vcp_tpu's on the CPU: the validation
decoder (``codec.h265.decoder``) on the port's own streams, the foreign
decoder (``codec.h265.foreign``) on the eight x265 goldens and on an
intra-only stream of the port's, and HEVC-in-MP4 ingest transcoded with
``-p h264-nvenc`` byte-identically. Planes are compared exactly."""

import glob
import os

import numpy as np
import pytest

from vcp_tpu.codec.h265 import decoder as jdec
from vcp_tpu.codec.h265.foreign import ForeignHevcDecoder as JForeign
from vcp_tpu.codec.h265.foreign import ForeignHevcError as JForeignError
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.config import BUILTIN_PRESETS
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch import cli as t_cli
from vcp_tpu_torch.codec.h265 import decoder as tdec
from vcp_tpu_torch.codec.h265 import encoder as tenc
from vcp_tpu_torch.codec.h265.foreign import ForeignHevcDecoder as TForeign
from vcp_tpu_torch.codec.h265.foreign import ForeignHevcError as TForeignError
from vcp_tpu_torch.codec.mp4 import split_annexb

from video_util import synth_video

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
X265 = sorted(glob.glob(os.path.join(GOLDEN, "*_x265_*.265")))
W, H = 104, 72          # padded to 128 x 96, cropped by the SPS window


def _planes_equal(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        for pa, pb in zip(fa, fb):
            np.testing.assert_array_equal(pa, pb)


@pytest.fixture(scope="module")
def streams():
    """The port's Annex-B streams at three settings (IDR + P, a cut)."""
    fr = synth_video(W, H, 6)
    fr = fr[:4] + [tuple(255 - p for p in f) for f in fr[4:]]
    out = {}
    for name, kw in (("row", dict(effort=4, qp=24)),
                     ("rd", dict(effort=5, qp=30)),
                     ("hq", dict(effort=7, qp=12)),
                     ("intra", dict(effort=5, qp=28, gop_size=1))):
        cfg = tenc.HevcEncoderConfig(width=W, height=H, **kw)
        vps, sps, pps, samples = tenc.encode_stream(fr, cfg, device="cpu")
        hdr = b"".join(b"\x00\x00\x00\x01" + n for n in (vps, sps, pps))
        out[name] = hdr + b"".join(s[0] for s in samples)
    return fr, out


@pytest.mark.parametrize("name", ["row", "rd", "hq", "intra"])
def test_validation_decoder(streams, name):
    """HevcDecoder (its deblock through the numpy entry point) gives
    vcp_tpu's planes on the port's stream, close to the source."""
    fr, es = streams
    ours = list(tdec.decode_annexb(es[name]))
    _planes_equal(ours, list(jdec.decode_annexb(es[name])))
    assert len(ours) == len(fr) and ours[0][0].shape == (H, W)
    err = np.abs(ours[0][0].astype(int) - fr[0][0].astype(int)).mean()
    assert err < 6


def _foreign(cls, error, data):
    dec = cls()
    out = []
    try:
        for nal in split_annexb(data):
            o = dec.decode_nal(nal)
            if o is not None:
                out.append(o)
    except error as e:
        return out, str(e)
    return out, None


@pytest.mark.parametrize("path", X265, ids=os.path.basename)
def test_foreign_decoder_on_x265_goldens(path):
    """The first (intra) picture equals vcp_tpu's; the first inter slice
    fails with the same error in both."""
    with open(path, "rb") as fh:
        data = fh.read()
    ours, err = _foreign(TForeign, TForeignError, data)
    ref, ref_err = _foreign(JForeign, JForeignError, data)
    assert len(ours) >= 1
    _planes_equal(ours, ref)
    assert err == ref_err and err is not None and "inter" in err


def test_foreign_decoder_on_the_ports_intra_stream(streams):
    """An intra-only stream of the port's (RD intra, effort 5) decodes in
    the foreign decoder to the validation decoder's planes."""
    _, es = streams
    ours, err = _foreign(TForeign, TForeignError, es["intra"])
    assert err is None
    _planes_equal(ours, list(tdec.decode_annexb(es["intra"])))


def test_hevc_mp4_ingest_transcode(tmp_path):
    """An intra-only HEVC MP4 of the port's (``-g 1``) transcoded with
    ``-p h264-nvenc`` through both executors: the same bytes."""
    src = str(tmp_path / "in.y4m")
    write_y4m(src, synth_video(W, H, 3), fps_num=30)
    hevc = str(tmp_path / "hevc.mp4")
    assert t_cli.main(["encode", src, hevc, "--ffmpeg-args=-c:v hevc_nvenc "
                       "-preset p4 -b:v 8M -g 1", "--device", "cpu"]) == 0
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    j_executor.execute(hevc, ref, BUILTIN_PRESETS["h264-nvenc"])
    assert t_cli.main(["encode", hevc, out, "-p", "h264-nvenc", "--device",
                       "cpu"]) == 0
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
