"""Frame scaling of vcp_tpu_torch against vcp_tpu on the CPU, tolerance 0:
``bilinear_resize`` and ``scale_yuv420`` on seeded planes (downscales,
upscales, odd targets), the single-rounding multiply-add they are built
on, ``resolve_scale``'s table with its errors, and whole encodes with
``-s`` / ``-vf scale`` (byte-identical MP4s)."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from vcp_tpu.codec.h264 import encoder as je
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.ops import scale as js
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch.codec.h264 import encoder as te
from vcp_tpu_torch.ops import scale as ts
from vcp_tpu_torch.pipeline import executor as t_executor

from video_util import synth_video

# (in h, in w, out h, out w): the shipped 4K -> 1080p, 1080p -> 720p and
# 480p, a small one, a 2x upscale, then odd targets, narrow outputs and
# upscales by ratios that are not whole numbers
SHAPES = [(1080, 1920, 720, 1280), (2160, 3840, 1080, 1920),
          (1080, 1920, 480, 854), (96, 128, 60, 80), (540, 960, 1080, 1920),
          (64, 96, 37, 51), (48, 64, 17, 9), (100, 70, 33, 130),
          (97, 61, 45, 29), (720, 1280, 1080, 1920), (33, 17, 80, 77),
          (8, 8, 3, 5)]


def _plane(rng, h, w, smooth):
    if not smooth:
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip(128 + 100 * np.sin(xx / 7.3) * np.cos(yy / 5.1), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d-%dx%d" % s)
def test_bilinear_resize_identical(shape):
    """Noise and a smooth pattern: every output sample equals
    vcp_tpu's."""
    h, w, oh, ow = shape
    rng = np.random.default_rng(h * 7919 + ow)
    for smooth in (False, True):
        x = _plane(rng, h, w, smooth)
        want = np.asarray(js.bilinear_resize(x, oh, ow))
        got = ts.bilinear_resize(torch.from_numpy(x), oh, ow)
        assert got.dtype == torch.uint8 and got.shape == (oh, ow)
        np.testing.assert_array_equal(got.numpy(), want)


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to ``x``, ties to even, from exact
    arithmetic."""
    f = np.float32(float(x))
    g = np.nextafter(f, np.float32(np.inf if Fraction(float(f)) < x
                                   else -np.inf))
    lo, hi = sorted((f, g))
    dlo, dhi = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def test_fma_rounds_once():
    """``_fma`` is the exactly rounded a * b + c on random operands and
    on sums next to a float32 rounding midpoint, where rounding first to
    float64 and then to float32 goes wrong (some of these cases do)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-300, 300, 400).astype(np.float32)
    b = rng.uniform(0, 1, 400).astype(np.float32)
    c = rng.uniform(-300, 300, 400).astype(np.float32)
    # c + 2^-24 is halfway between c and c + 2^-23 for c in [1, 2); with
    # a * b = 2^-24 (1 - 2^-2m) the exact sum lies 2^-(24 + 2m) below
    # it, which float64 cannot hold: rounded there first, an odd c then
    # rounds up instead of down
    m, j = np.meshgrid(np.arange(15, 24), np.arange(1, 40, 2))
    a = np.concatenate([a, (1 + 2.0 ** -m.ravel()).astype(np.float32)])
    b = np.concatenate([b, (2.0 ** -24 * (1 - 2.0 ** -m.ravel()))
                        .astype(np.float32)])
    c = np.concatenate([c, (1 + j.ravel() * 2.0 ** -23).astype(np.float32)])
    got = ts._fma(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).any()


@pytest.mark.parametrize("target", [(720, 1280), (37, 51), (61, 83)])
def test_scale_yuv420_identical(target):
    """All three planes, targets rounded down to even."""
    rng = np.random.default_rng(sum(target))
    y = _plane(rng, 108, 192, False)
    u, v = _plane(rng, 54, 96, False), _plane(rng, 54, 96, True)
    want = js.scale_yuv420(y, u, v, *target)
    got = ts.scale_yuv420(y, u, v, *target, device="cpu")
    assert [p.shape for p in got] == [p.shape for p in want]
    for g, w_ in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w_)


def test_scale_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = np.zeros((16, 16), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.scale_yuv420(p, p[:8, :8], p[:8, :8], 8, 8)


def _resolve(mod, *a):
    try:
        return mod.resolve_scale(*a)
    except ValueError as e:
        return ("ValueError", str(e))


def test_resolve_scale_table():
    """Every combination of target width / height (given, 0, -1, -2,
    negative) against three source sizes, errors included."""
    sizes = (0, -1, -2, -3, 1, 2, 48, 853, 1280, 1920)
    got = [_resolve(te, sw, sh, *src) for sw in sizes for sh in sizes
           for src in ((1920, 1080), (1280, 720), (97, 61))]
    want = [_resolve(je, sw, sh, *src) for sw in sizes for sh in sizes
            for src in ((1920, 1080), (1280, 720), (97, 61))]
    assert got == want
    assert ("ValueError", "scale: width and height cannot both be -1/-2") \
        in got and te.resolve_scale(1920, -2, 3840, 2160) == (1080, 1920)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """A 96x64 Y4M of two frames (an IDR and a P frame)."""
    path = str(tmp_path_factory.mktemp("scale") / "in.y4m")
    write_y4m(path, synth_video(96, 64, 2))
    return path


@pytest.mark.parametrize("args", [
    "-c:v libx264 -preset veryslow -s 64x48",
    "-c:v h264_nvenc -preset p4 -vf scale=48:-2",
])
def test_scaled_encode_identical(src, tmp_path, args):
    """The scaled encode's MP4 equals vcp_tpu's byte for byte, at the
    size the target asks for."""
    from vcp_tpu_torch.codec.mp4 import Mp4Demuxer
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    j_executor.execute(src, ref, args)
    t_executor.execute(src, out, args, device="cpu")
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    v = Mp4Demuxer(out).video
    assert (v.width, v.height) == ((64, 48) if "-s" in args else (48, 32))
