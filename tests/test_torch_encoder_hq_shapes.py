"""The quarter-pel shapes of vcp_tpu_torch beside ``-p h264-nvenc-hq``
against vcp_tpu on the CPU: byte-identical MP4 files for effort 8
(``-preset veryslow``, +-24 on anchors and B pictures), partitions below
effort 5 with B pictures (``VCP_PARTS=1``: full-pel vectors through the
quarter-pel MC) and the hq preset with ``VCP_HIER_ME=0`` (the exhaustive
searches). Kept apart from ``test_torch_encoder_hq.py`` so that the two
files' vcp_tpu compiles run on different test workers.

vcp_tpu reads VCP_HIER_ME while it traces and caches the trace by frame
size and static arguments, so the case with VCP_HIER_ME=0 uses a frame
width (W0) that no other test encodes."""

import pytest

from test_torch_encoder_hq import HQ, W, _execute_pair, qframes
from vcp_tpu.codec.y4m import write_y4m

W0 = 240                     # frame width of the VCP_HIER_ME=0 case


@pytest.mark.parametrize("name,ffargs,w,env", [
    # effort 8: +-24 on anchors and B pictures
    ("veryslow", "-c:v libx264 -preset veryslow -crf 26", W, ()),
    # partitions below effort 5: full-pel vectors through mc_luma_q
    ("p4-bf2-parts", "-c:v h264_nvenc -preset p4 -bf 2 -b:v 10M", W,
     (("VCP_PARTS", "1"),)),
    # the exhaustive searches: kernel 2's plain version at +-16 on both B
    # lists, the exhaustive partition search on the anchors
    ("hq-exhaustive", HQ, W0, (("VCP_HIER_ME", "0"),)),
])
def test_quarter_pel_shapes_mp4_identical(tmp_path, monkeypatch, name,
                                          ffargs, w, env):
    src = str(tmp_path / "in.y4m")
    write_y4m(src, qframes(10, w=w, cut=7), fps_num=6)
    port, ref, _ = _execute_pair(tmp_path, name, src, ffargs, monkeypatch,
                                 env)
    assert port == ref
