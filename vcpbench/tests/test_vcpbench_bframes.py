"""The comparison on a stream with B pictures: the shipped ``h264-cpu``
preset (``libx264 -preset medium -crf 23``, 2 B pictures) coded by the
port on the CPU at 192x112. Its samples are stored in decode order
(I0 P3 B1 B2 P6 B4 ...); the composition offsets put them in display
order, and the comparison judges each picture against the source frame
it shows. Offsets that show the wrong frames, or none, are refused."""

import dataclasses

import pytest

from vcpbench import check, mp4read, spec
from vcpbench.content import Content, write_y4m
from vcpbench.h264ref.decoder import H264Decoder

W, H, N, GOP, SEED = 192, 112, 24, 12, 7
ARGS = f"-c:v libx264 -preset medium -crf 23 -g {GOP} -movflags +faststart"


def _cell():
    """``x264bf0-pan``'s configuration with its B pictures back, at the
    test's size, and its mix and limits."""
    cell = spec.load_cell("x264bf0-pan")
    cfg = dict(cell.config, args=ARGS, width=W, height=H, gop=GOP,
               bframes=2)
    traffic = dict(cell.traffic,
                   loop=dict(cell.traffic["loop"], frames_per_task=N))
    return cfg, traffic, cell.limits


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    from vcp_tpu_torch.pipeline import executor
    d = tmp_path_factory.mktemp("bframes")
    src, out = str(d / "in.y4m"), str(d / "out.mp4")
    _, traffic, _ = _cell()
    write_y4m([(src, N)], Content(traffic["content"], W, H, SEED), 30, 1)
    executor.execute(src, out, ARGS, device="cpu")
    return out


def _judge(path):
    cfg, traffic, limits = _cell()
    res = check.compare([path], cfg, traffic, SEED, workers=4)
    return res, check.verdict(dict(res["numbers"], tasks_failed=0),
                              limits)[0]


def _with_offsets(monkeypatch, change):
    """``mp4read.read`` as the comparison's own process sees it, with the
    video track's composition offsets changed by ``change(offsets)``."""
    real = mp4read.read

    def read(path):
        movie, data = real(path)
        tr = movie.tracks[0]
        tr = dataclasses.replace(tr, cts_offsets=change(tr.cts_offsets))
        return dataclasses.replace(movie, tracks=[tr]), data
    monkeypatch.setattr(mp4read, "read", read)


def test_display_order():
    tr = mp4read.Track(sizes=[1] * 5, durations=[1000] * 5)
    assert check.display_order(tr) == [0, 1, 2, 3, 4]
    tr.cts_offsets = [1000, 3000, 0, 0, 1000]        # I0 P3 B1 B2 P4
    assert check.display_order(tr) == [0, 3, 1, 2, 4]
    tr.cts_offsets = [2000, 4000, 1000, 1000, 2000]  # a delay of 2 frames
    assert check.display_order(tr) == [0, 3, 1, 2, 4]
    tr.cts_offsets = [1000, 3000, 500, 0, 1000]      # any times, by rank
    assert check.display_order(tr) == [0, 3, 1, 2, 4]
    tr.cts_offsets = [1000, 3000, 1000, 0, 1000]     # B1 shown with B2
    with pytest.raises(ValueError, match="one time"):
        check.display_order(tr)
    tr.cts_offsets = [1000, 3000, 0, 0]
    with pytest.raises(ValueError):
        check.display_order(tr)


def test_stream_is_in_decode_order(stream):
    movie, _ = mp4read.read(stream)
    shown = check.display_order(movie.tracks[0])
    assert shown[:6] == [0, 3, 1, 2, 6, 4]
    assert sorted(shown) == list(range(N))


def test_b_stream_is_correct(stream):
    res, correct = _judge(stream)
    assert correct, res["numbers"]
    assert res["numbers"]["syntax_faults"] == 0
    assert res["frames_decoded"] == 2 * 6


def test_b_slice_parses_after_its_anchors(stream):
    """A B sample parsed alone lacks its anchors; after the slice headers
    of the samples before it, it parses to its end."""
    movie, data = mp4read.read(stream)
    tr = movie.tracks[0]

    def decoder(skim):
        dec = H264Decoder()
        dec.parse_only = True
        for nal in tr.sps + tr.pps:
            dec._decode_nal(nal)
        dec.headers_only = True
        for i in skim:
            for nal in mp4read.sample_nals(tr, data, i):
                dec._decode_nal(nal)
        dec.headers_only = False
        return dec

    b = 8                                  # B7, after P6 and P9
    with pytest.raises(Exception, match="anchor"):
        decoder([])._decode_nal(mp4read.sample_nals(tr, data, b)[0])
    dec = decoder(range(b))
    dec._decode_nal(mp4read.sample_nals(tr, data, b)[0])
    assert dec.parsed == b + 1


def test_anchor_and_b_swapped_is_not_correct(stream, monkeypatch):
    """The display places of P3 and B1 (samples 1 and 2) exchanged: every
    frame is still shown once, but two pictures are shown at each
    other's place. Every B picture of this layout has the offset 0, and
    a B shown before the B decoded ahead of it would need a negative
    offset, so an anchor and a B are the pair that can be swapped."""
    def swap(offsets):
        o = list(offsets)
        o[1], o[2] = 1000, 2000        # decode 1 -> frame 1, 2 -> frame 3
        assert (offsets[1], offsets[2]) == (3000, 0)
        return o
    _with_offsets(monkeypatch, swap)
    res, correct = _judge(stream)
    assert not correct
    assert res["numbers"]["container_faults"] == 0
    assert res["numbers"]["lowpass_mse"] > _cell()[2]["lowpass_mse"]


@pytest.mark.parametrize("change", [
    lambda o: None,                                   # no ctts at all
    lambda o: [o[0] + 1000] + list(o[1:]),            # I0 shown with B1
    lambda o: list(o[:-1]),                           # one offset short
], ids=["no-ctts", "two-at-one-time", "short-table"])
def test_bad_offsets_are_container_faults(stream, monkeypatch, change):
    _with_offsets(monkeypatch, change)
    res, correct = _judge(stream)
    assert not correct
    assert res["numbers"]["container_faults"] >= 1
