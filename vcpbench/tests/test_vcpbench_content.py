"""The content generator: the same seed gives the same frames, and each
mix changes the 16x16 tiles it states a frame."""

import numpy as np
import pytest

from vcpbench import spec
from vcpbench.content import Content, write_y4m


def _mix(name):
    import json
    import os
    with open(os.path.join(spec.HERE, "traffic", name + ".json")) as fh:
        return json.load(fh)["content"]


def _changed_tiles(a, b):
    h, w = a.shape
    d = (a != b)
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    d = np.pad(d, ((0, hp - h), (0, wp - w)))
    return int(d.reshape(hp // 16, 16, wp // 16, 16).any(axis=(1, 3)).sum())


@pytest.mark.parametrize("mix", ["pan", "box"])
def test_deterministic_per_seed(mix):
    big = 2 ** 31 + 11
    a = Content(_mix(mix), 96, 64, big).frame(5)
    b = Content(_mix(mix), 96, 64, big).frame(5)
    c = Content(_mix(mix), 96, 64, big + 1).frame(5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    n = Content(_mix(mix), 96, 64, -3).frame(0)
    assert n[0].shape == (64, 96) and n[1].shape == (32, 48)


def test_frames_stand_alone():
    """Frame t is the same whether made alone or after others."""
    c1 = Content(_mix("pan"), 96, 64, 9)
    seq = [c1.frame(t) for t in range(4)]
    alone = Content(_mix("pan"), 96, 64, 9).frame(3)
    assert all(np.array_equal(x, y) for x, y in zip(seq[3], alone))


def test_pan_changes_every_tile_at_1080p():
    c = Content(_mix("pan"), 1920, 1080, 4)
    a, b = c.frame(7)[0], c.frame(8)[0]
    assert _changed_tiles(a, b) == 8160


def test_box_changes_289_tiles_at_1080p():
    c = Content(_mix("box"), 1920, 1080, 4)
    for t in (0, 7, 30):
        a, b = c.frame(t)[0], c.frame(t + 1)[0]
        assert _changed_tiles(a, b) == 17 * 17


def test_y4m_written_once_for_two_files(tmp_path):
    c = Content(_mix("pan"), 32, 16, 1)
    p1, p2 = tmp_path / "a.y4m", tmp_path / "b.y4m"
    write_y4m([(str(p1), 3), (str(p2), 2)], c, 30, 1)
    frame = 32 * 16 * 3 // 2 + 6
    head = len(b"YUV4MPEG2 W32 H16 F30:1 Ip A1:1 C420jpeg\n")
    assert p1.stat().st_size == head + 3 * frame
    assert p2.stat().st_size == head + 2 * frame
    assert p1.read_bytes()[:head + 2 * frame] == p2.read_bytes()
