"""The reference decoder against two witnesses: libx264's streams in
``tests/golden``, decoded to the pictures whose PSNR libx264's sources
give, and streams the port encodes on the CPU at a small size, decoded
to the same pictures as the port's own decoder (its C++ parse and
reconstruction); a parse-only mode that reads every slice, and a flipped
byte that it refuses."""

import json
import os

import numpy as np
import pytest

from vcpbench import mp4read, spec
from vcpbench.content import Content, write_y4m
from vcpbench.h264ref.decoder import H264Decoder

GOLDEN = os.path.join(spec.ROOT, "tests", "golden")

ARGS = {
    "nvenc": "-c:v h264_nvenc -preset p4 -b:v 300k -movflags +faststart",
    "x264bf0": "-c:v libx264 -preset medium -bf 0 -crf 23 "
               "-movflags +faststart",
}
PAN = {"background": {"kind": "pan", "dx": 1.5, "dy": 0.5, "noise": 3},
       "boxes": []}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    from vcp_tpu_torch.pipeline import executor
    d = tmp_path_factory.mktemp("ref")
    src = str(d / "in.y4m")
    write_y4m([(src, 12)], Content(PAN, 96, 64, 3), 30, 1)
    out = {}
    for name, args in ARGS.items():
        p = str(d / f"{name}.mp4")
        executor.execute(src, p, args + " -g 6", device="cpu")
        out[name] = p
    return out


def _frames(path, decoder):
    movie, data = mp4read.read(path)
    tr = movie.tracks[0]
    for nal in tr.sps + tr.pps:
        decoder._decode_nal(nal)
    for i in range(len(tr.sizes)):
        for nal in mp4read.sample_nals(tr, data, i):
            decoder._decode_nal(nal)
    return decoder


@pytest.mark.parametrize("name", sorted(ARGS))
def test_same_pictures_as_the_ports_decoder(streams, name):
    from vcp_tpu_torch.codec.h264.decoder import H264Decoder as PortDecoder
    ref = _frames(streams[name], H264Decoder()).frames
    port = _frames(streams[name], PortDecoder()).frames
    assert len(ref) == len(port) == 12
    for a, b in zip(ref, port):
        for pa, pb in zip((a.y, a.u, a.v), (b.y, b.u, b.v)):
            assert np.array_equal(pa, pb)


@pytest.mark.parametrize("name", sorted(ARGS))
def test_parse_only_reads_every_slice(streams, name):
    dec = H264Decoder()
    dec.parse_only = True
    assert _frames(streams[name], dec).parsed == 12
    assert dec.frames == []


def test_flipped_byte_is_refused(streams, tmp_path):
    movie, data = mp4read.read(streams["nvenc"])
    tr = movie.tracks[0]
    nal = mp4read.sample_nals(tr, data, 3)[0]
    bad = bytearray(nal)
    bad[len(bad) // 2] ^= 0x5A
    dec = H264Decoder()
    dec.parse_only = True
    for n in tr.sps + tr.pps:
        dec._decode_nal(n)
    with pytest.raises(Exception):
        dec._decode_nal(bytes(bad))


def _annexb_nals(data: bytes) -> list:
    """The NAL units of an Annex-B byte stream."""
    starts, i = [], data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i + 3)
        i = data.find(b"\x00\x00\x01", i + 3)
    ends = [s - 3 for s in starts[1:]] + [len(data)]
    return [data[a:b].rstrip(b"\x00") for a, b in zip(starts, ends)]


@pytest.mark.parametrize("clip,crf", [
    ("gradmotion_320x192", "20"), ("gradmotion_320x192", "32"),
    ("texture_256x160", "26"), ("texture_256x160", "38")])
def test_libx264_streams_decode_to_their_psnr(clip, crf):
    """An independent witness: libx264's CABAC streams (High profile, I,
    P and B slices, 4 references) decode to pictures whose luma PSNR
    against the sources is the one recorded beside them."""
    with open(os.path.join(GOLDEN, "meta.json")) as fh:
        meta = json.load(fh)[clip]
    with open(os.path.join(GOLDEN, f"{clip}_x264_crf{crf}.264"), "rb") as fh:
        frames = H264Decoder().decode_nals(_annexb_nals(fh.read()))
    src = np.load(os.path.join(GOLDEN, clip + ".npz"))
    assert len(frames) == meta["n"]
    mse = np.mean([np.mean((f.y.astype(np.float64) - src[f"f{k}_y"]) ** 2)
                   for k, f in enumerate(frames)])
    assert abs(10 * np.log10(255.0 ** 2 / mse)
               - meta["x264"][crf]["luma_psnr"]) < 0.005
