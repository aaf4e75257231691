"""The benchmark's MP4 reader, ``kbps`` and PSNR, against MP4 files the
port's muxer writes."""

import numpy as np
import pytest

from vcpbench import check, mp4read


def _mux(path, sizes, sync, fps=(30, 1)):
    from vcp_tpu_torch.codec.h264.encoder import mux_mp4
    sps = bytes([0x67, 0x42, 0xC0, 0x1E, 0xDA, 0x02, 0x80, 0xBF, 0xE5])
    pps = bytes([0x68, 0xCE, 0x3C, 0x80])
    samples = []
    for i, n in enumerate(sizes):
        nal_type = 5 if i in sync else 1
        body = bytes([0x60 | nal_type]) + bytes((i + k) % 251 + 1
                                                for k in range(n - 1))
        samples.append((b"\x00\x00\x00\x01" + body, i in sync))
    mux_mp4(str(path), sps, pps, samples, 64, 48, *fps, faststart=True)


def test_reader_and_kbps(tmp_path):
    sizes = [900, 120, 130, 140, 880, 150]
    p = tmp_path / "a.mp4"
    _mux(p, sizes, {0, 4})
    movie, data = mp4read.read(str(p))
    [tr] = movie.tracks
    assert (tr.handler, tr.codec, tr.width, tr.height) == ("vide", "avc1",
                                                            64, 48)
    assert tr.sizes == [n + 4 for n in sizes]        # 4-byte NAL lengths
    assert tr.sync == [0, 4]
    assert len(tr.durations) == 6
    assert all(d * 30 == tr.timescale for d in tr.durations)
    assert [t for t, _, _ in movie.top].index("moov") < \
        [t for t, _, _ in movie.top].index("mdat")
    nals = mp4read.sample_nals(tr, data, 4)
    assert len(nals) == 1 and len(nals[0]) == 880 and nals[0][0] & 31 == 5
    seconds = 6 / 30
    assert mp4read.video_kbps(tr) == pytest.approx(
        sum(n + 4 for n in sizes) * 8 / seconds / 1000)


def test_container_faults(tmp_path):
    cfg = {"width": 64, "height": 48, "fps_num": 30, "fps_den": 1,
           "gop": 4, "faststart": True}
    p = tmp_path / "a.mp4"
    _mux(p, [100] * 6, {0, 4})
    movie, data = mp4read.read(str(p))
    assert check.container_faults(movie, data, cfg, 6) == []
    assert check.container_faults(movie, data, dict(cfg, gop=3), 6)
    assert check.container_faults(movie, data, cfg, 7)
    _mux(p, [100] * 6, {0, 3})
    movie, data = mp4read.read(str(p))
    assert len(check.container_faults(movie, data, cfg, 6)) >= 2


def test_truncated_file_is_refused(tmp_path):
    p = tmp_path / "a.mp4"
    _mux(p, [100] * 6, {0, 4})
    raw = p.read_bytes()
    p.write_bytes(raw[:-50])
    with pytest.raises(mp4read.Mp4Error):
        movie, data = mp4read.read(str(p))
        tr = movie.tracks[0]
        for i in range(len(tr.sizes)):
            mp4read.sample_nals(tr, data, i)


def test_psnr():
    assert check.psnr(0.0) == 99.0
    assert check.psnr(255.0 ** 2) == pytest.approx(0.0)
    a = np.zeros((4, 4))
    b = np.full((4, 4), 10.0)
    mse = float(np.mean((a - b) ** 2))
    assert check.psnr(mse) == pytest.approx(10 * np.log10(255 ** 2 / 100))
