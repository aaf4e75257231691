"""How a run conducts itself, rehearsed on the CPU: the parts of set-up
sum to ``setup_s``; the warm-up codes one whole task of the window's own
clip, so it covers every GOP shape the window codes; a traced run writes
the host probe of each task beside the metrics, an untimed one does
not; and the comparison's readings of the cells are those it gave before
the conduct changed."""

import pytest

from vcpbench import bench, loop

SIZE = (96, 64)


def _rehearse(workload, traced, seed=3):
    return bench.run_cell(workload, seed, 0.1, traced, device="cpu",
                          size=SIZE)


@pytest.fixture(scope="module")
def traced_run():
    return _rehearse("nvenc-box", True)


@pytest.fixture(scope="module")
def timed_run():
    """An untraced run, with the GOP sizes that each task coded (the
    warm-up's tasks have negative indices)."""
    from vcp_tpu_torch.codec.h264.encoder import H264Encoder
    gops: dict = {}
    current = [None]
    real_task, real_gop = loop.run_task, H264Encoder.encode_gop

    def run_task(i, *args, **kw):
        current[0] = i
        return real_task(i, *args, **kw)

    def encode_gop(self, frames):
        gops.setdefault(current[0], []).append(len(frames))
        return real_gop(self, frames)
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "run_task", run_task)
    mp.setattr(H264Encoder, "encode_gop", encode_gop)
    try:
        result = _rehearse("x264bf0-pan", False)
    finally:
        mp.undo()
    return result, gops


def test_setup_parts_sum_to_setup_s(timed_run):
    result, _ = timed_run
    parts = result["setup_parts"]
    assert list(parts) == ["process_start", "torch", "content",
                           "cuda_context", "warmup"]
    assert all(v >= 0 for v in parts.values())
    assert sum(parts.values()) == pytest.approx(
        result["metrics"]["setup_s"]["value"], rel=1e-9)


def test_warmup_codes_the_windows_gop_shapes(timed_run):
    result, gops = timed_run
    warm = [g for i, g in gops.items() if i < 0]
    window = [g for i, g in gops.items() if i >= 0]
    assert len(warm) == 1 and len(window) == result["attempted"]
    assert all(g == warm[0] for g in window), (warm, window)


def test_traced_run_writes_the_probe(traced_run):
    r = traced_run
    assert len(r["task_s"]) == len(r["host_probe_s"]) == r["attempted"]
    assert all(p > 0 for p in r["host_probe_s"])
    assert sum(r["setup_parts"].values()) > 0


def test_timed_run_has_no_probe(timed_run):
    result, _ = timed_run
    assert "host_probe_s" not in result
    assert len(result["task_s"]) == result["attempted"]


def test_setup_clock():
    clock = bench.SetupClock(10.0, 1.5)
    clock.mark("a", 12.0)
    clock.mark("b", 12.25)
    assert clock.parts == {"process_start": 1.5, "a": 2.0, "b": 0.25}
    assert clock.total() == 3.75


# The comparison's readings of a rehearsal at 192x128, seed 5, as the
# harness read them before the whole-task warm-up and the B-picture
# comparison: neither may move a reading of a stream without B pictures.
READINGS = {
    "x264bf0-pan": {"lowpass_mse": 0.33388010660807294,
                    "psnr_db": 42.59310275362426, "kbps": 114.364,
                    "mse_worst": 4.004475911458333},
    "nvenc-box": {"lowpass_mse": 0.03495661417643229,
                  "psnr_db": 44.31054982737078, "kbps": 176.644,
                  "mse_worst": 3.103759765625},
}


@pytest.mark.parametrize("workload", sorted(READINGS))
def test_readings_are_unchanged(workload):
    r = bench.run_cell(workload, 5, 0.1, False, device="cpu",
                       size=(192, 128))
    got = {"lowpass_mse": r["checks"]["lowpass_mse"]["value"],
           "psnr_db": r["metrics"]["psnr_db"]["value"],
           "kbps": r["metrics"]["kbps"]["value"],
           "mse_worst": r["mse_worst"]}
    assert got == READINGS[workload]
    assert r["correct"] and r["frames_decoded"] == 12
