"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vcp_tpu_torch/csrc`` and holds each
against its plain PyTorch version on the card at 1080p (exact equality:
the codec is integer-exact). The motion-search kernel is also held
against its plain version and against the reference design (the per-MB
kernel of the first slice) at every search range of the effort ladder,
0 and 32, on content from flat to saturated, at 16x16, one MB row, one
MB column and 2160p, and on a few hundred random frames; a child process
checks that a sample outside 0..255 makes it fail. Its bound comes from
the absolute-difference sequence rates measured in the same run
(``vcp_tpu_torch.tools.probe_motion``). The one-launch deblocking
kernels are also held against it at shapes that stress their schedule
(one MB row, one MB column, 2160p) and, over several hundred random
frames, half of them beside a busy second stream, against the
per-diagonal reference kernels.
Then it drives the port's main paths end to end through ``python -m
vcp_tpu_torch.cli encode`` on ``cuda``, each with the kernels' launch
counters zeroed just before and read just after:

* the speed shape, ``-p h264-nvenc`` (full-pel ME with the fused
  search + prediction kernel, row-pattern IDR);
* the half-pel quality shape without B pictures, ``-c:v libx264 -preset
  medium -bf 0`` (half-pel ME, adaptive 8x8 transform, RD intra IDR),
  once as it comes (pyramid search) and once with ``VCP_HIER_ME=0``,
  which sends the full-pel search through the search-only kernel;
* the shipped quality preset, ``-p h264-cpu`` (the same tools plus 2 B
  pictures, partitioned P anchors and intra MBs in P pictures), as it
  comes and with ``VCP_HIER_ME=0`` (the B pictures' searches through the
  search-only kernel, the anchors' through the exhaustive partition
  search);
* the speed shape with B pictures, ``-c:v h264_nvenc -preset p4 -bf 2``
  (the fused kernel on the B pictures and the +-24 anchors);
* the shipped preset ``-p h264-nvenc-hq`` (quarter-pel ME at +-16, the
  same B-GOP tools) on a real MP4 input: the MP4 that the ``h264-cpu``
  path has just written, demuxed and decoded on the host
  (``stage_s["decode"]``) and encoded again.

Phase 3b runs the containers, audio, copy and scaling paths, each with
the launch counts zeroed just before and read just after: ``-p
h264-nvenc`` from the ``h264-nvenc`` path's MP4 with 48 kHz stereo audio
as MP4 + AAC, MKV + AAC and AVI + s16 PCM (the same video NAL units out
of all three; each audio track there, re-encoded and decodable to the
clip's length), ``-p copy`` of the MP4 (byte-identical) and of the MKV
(its blocks and AAC frames in an MP4), ``-vn -c:a aac -b:a 128k`` (one
sound track) and 12 frames of 2160p with ``-vf scale=1920:-2``; and it
holds ``bilinear_resize`` on the card against the CPU.

Phase 3c runs HEVC, whose engine has no kernel of its own (its device
work is plain PyTorch), so all four kernels' counts must stay 0: ``-p
h265-nvenc`` and ``-p h265-cpu`` on 8 frames of 1080p (a scene cut at 5),
``-p h265-nvenc-hq`` from the phase-3b MP4 + AAC (40 frames, the audio
re-encoded at 192 kb/s), and HEVC ingest: 4 frames encoded intra-only
(``-g 1``) to an hvc1 MP4, decoded on the host by the foreign HEVC
decoder and encoded with ``-p h264-nvenc``. Each hvc1 MP4 is decoded by
the port's HEVC validation decoder (>= 30 dB against the source) in a
child process beside the later phases; quarter-phase vectors, the RD
paths' left-dependent intra modes and the host seconds of the CABAC
slice writer are logged and checked.

Phase 3d runs the control plane, the farm on one card: the port's
``redis-serve`` and two ``producer`` processes (``-p h264-nvenc`` and
``-p copy``, one shared and one output dir) feed a ``Consumer`` in this
process (two workers, ``device="cuda"``) over the Redis Stream, with
the launch counts set to 0 just before the consumer starts and read
when its tasks are done. The two transcodes (phase 3's Y4M and phase
3b's MP4 + AAC, at once) must equal their direct encodes NAL unit for
NAL unit and launch kernels 1, 3 and 4; the copy equals its source; a
VP9 WebM is refused at publish; a task without input is acked and
dropped; the queue, the shared dir and the history end as the reference
semantics say, and ``stats`` and ``clean --all`` print and clean them.

Phase 3e runs CAVLC and the I16-only RD IDR: ``VCP_CABAC=0`` with
``-c:v libx264 -preset fast -crf 23 -bf 0`` on 9 frames of 1080p beside
the same arguments under CABAC (the same launches of kernels 1, 3 and 4,
identical decoded pictures, the last equal to the encoder's recon, a PPS
with entropy_coding_mode_flag 0), ``VCP_CABAC=0 VCP_BFRAMES=2
VCP_PARTS=1 -p h264-cpu`` on the 5-frame B GOP (the I16-only RD IDR,
partitioned half-pel P anchors and B pictures through the Python CAVLC
writers) and ``VCP_RDI=1 -p h264-nvenc`` on 9 frames (the I16-only RD IDR
under CABAC); each MP4 is decoded by the host decoder, and the host
seconds of the entropy stage, of the Python CAVLC writers and of the RD
IDR's dispatch are logged.

Phase 3f runs the tile mesh (``parallel.mesh``) on the card: the CLI
encodes 9 frames of ``-p h264-nvenc`` with ``VCP_MESH=t`` and t copies of
``cuda:0`` visible, t = 2 and 4, so that each P frame runs as t bands
(kernel 1 with a row offset into the whole reference) and the gathered
planes are deblocked by ``deblock_general`` without the strong filter;
the launches must be the predicted ones and the NAL units those of the
one-device encode of the same frames. Then 5 frames of ``VCP_CABAC=0
-c:v libx264 -preset medium`` on 4 bands (sr 12 and half-pel: kernel 2
with a row offset), equal to the one-device encode with the exhaustive
search; the 4-band speed MP4 is decoded on the host. Phase 2 holds the
band form of kernels 1 and 2 against ``full_search`` / ``mc_luma`` with
``row0`` on 2 and 4 bands of 1088x1920 and times one band launch; phase
4 holds both mesh GOPs and ``encode_iframe_batch_sharded`` on 4 1080p
frames between ``cuda`` and ``cpu``; phase 5 profiles the mesh GOP at t
= 4. With more than one card the speed path also runs over the cards
themselves.

Phase 3g runs what crosses the bus: the delta upload (only the 16x16
source tiles that changed) and the sparse fetches, the defaults, each
beside ``VCP_DELTA=0`` (and ``VCP_SPARSE_B=0``) on the same frames, with
equal NAL units: ``-p h264-nvenc`` on 40 frames of 1080p where only a
256x256 box moves over a fixed background (a scene cut at 24 inverts
the background), ``-c:v h264_nvenc -preset p4 -bf 2 -g 5`` on 10 of
them (two B GOPs) and ``-p h264-nvenc`` on 9 frames of the speed path's
content, where every tile changes. Each runs under a device-only
profiler, and the H2D and D2H bytes come from the memcpy events of its
Kineto trace: a P chunk is one upload and one fetch (one more when it
overflows its caps); a P frame of the static content uploads at most a
tenth of the dense bytes, one of the changing content at most 2 % more.
Phase 4 holds two consecutive 3-frame GOPs of the static content (the
second IDR a delta) between ``cuda`` and ``cpu``, and phase 5 profiles
its 9-frame GOP with the delta upload and without.

Phase 3h decodes phase 3's ``h264-cpu`` MP4 in two spawned children
beside the later phases, natively and under ``VCP_NO_NATIVE=1`` (the
Python CABAC parsers, the numpy reconstruction and deblock): the frames
must be equal. ``--nonative-only`` runs it after encoding on the card
without the C++ library: each path beside its native twin on the same
frames, the twin first, with equal NAL units and equal launches of every
kernel; ``-p h264-nvenc`` on 3 frames and ``VCP_CABAC=0 -p h264-nvenc``
on 2 under ``VCP_NO_NATIVE=1`` (the Python CABAC and CAVLC writers, the
numpy tile pass), and ``-p h264-cpu`` on the 5-frame B GOP (i8 IDR,
partitions and the intra overlay, B pictures), whose MP4 it decodes. It
logs the host seconds of each slice writer call and of the tile pass
both ways: a check of the C++ writers against their Python twins at
1080p, for a change to either.

It checks each MP4 (with the composition offsets of B streams), checks
that the quality paths used the tools they add (quarter-pel vectors on
the hq path), decodes the ``h264-cpu`` MP4 with the port's host decoder
and holds it against the synthetic source, checks that a GOP's NAL
units and the last recon are identical between ``cuda`` and ``cpu``
(plain versions, the cpu sides in three child processes beside the
card's) on the speed path, the quality path without B pictures,
a B GOP of ``h264-cpu``, a B GOP of ``h264-nvenc-hq`` with
``VCP_HIER_ME=0`` (the search-only kernel at +-16 on both B lists), the
B GOP of phase 3e's CAVLC ``h264-cpu`` with ``VCP_HIER_ME=0``, and the
chunked quarter-pel P path (``-preset p7 -bf 0``) and IDR + 2 P of
``h265-nvenc`` and
``h265-cpu``, profiles the first three GOPs and an ``h265-cpu`` IDR + 2
P (with the host seconds of its CABAC), and prints per-kernel times
beside their bounds. Any failed phase raises, so the exit code is
nonzero; without a CUDA device it exits 2 and prints no result.
``--kernels-only`` stops after the kernel checks (a short first run
after a kernel change), ``--hevc-only`` runs the HEVC phases alone (the
hq path from 12 frames); neither prints a result line.
``--cavlc-only`` runs phase 3e and its phase-4 GOP alone and prints no
result; ``--mesh-only`` runs the band checks of phase 2, phase 3f and
its phase-4 and phase-5 work and prints no result; so does
``--bus-only`` for phase 3g and ``--nonative-only`` for phase 3h.
``--control-only`` runs phase 3d alone on a
fresh 40-frame Y4M
and its own MP4 + AAC and ends with the same last line. Imports nothing of JAX
or of ``vcp_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 1080, 1920            # source frame (padded to 1088 x 1920)
HP = 1088                    # padded luma height
N_FRAMES = 40
SCENE_CUT = 24               # first frame of the second scene
Q_ARGS = ("-c:v libx264 -preset medium -bf 0 -b:v 10M "
          "-movflags +faststart")      # the half-pel quality shape
Q_FRAMES = 12
Q_CUT = 8
Q_SR = 12                    # its search range (effort 5)
B_FRAMES = 5                 # frames of the paths with B pictures: one
                             # GOP (12 frames cut at 8 until the HEVC
                             # paths came)
NVENC_B_ARGS = ("-c:v h264_nvenc -preset p4 -bf 2 -b:v 10M "
                "-movflags +faststart")
P7_ARGS = "-c:v h264_nvenc -preset p7 -bf 0 -b:v 15M"   # chunked quarter-pel
DECODE_PSNR_FLOOR_DB = 30.0  # host decode of the h264-cpu MP4 vs its source
DEVICE = "cuda"              # the device every main path is driven on
STRESS_SHAPES = ((16, 1920), (1088, 16), (2160, 3840))
PSNR_FLOOR_DB = 35.0         # recon luma PSNR floor of the first GOP
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the CUDA-core
# float32 rate taken as the integer-op ceiling (int32 runs at no more
# than this rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
WALL_S: dict[str, float] = {}  # wall of each main path's CLI encode


@contextlib.contextmanager
def scoped_env(env: dict | None):
    """Set environment variables for the duration of the block."""
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, dev: torch.device, reps: int, warmup: int = 1) -> float:
    """Median ms of ``fn()`` over ``reps`` runs (CUDA events on a GPU)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(outs, refs) -> int:
    err = 0
    for a, b in zip(outs, refs):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()))
    return err


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

MOTION_SRS = (0, 4, 6, 8, 12, 16, 24, 32)   # the effort ladder, 0, the limit
MOTION_LAMS = (0, 22, 1000)                 # none, the speed path's, large
MOTION_SHAPES = ((16, 16), *STRESS_SHAPES)
MOTION_ROWS = ((True, 8, 22, "motion_search", 207),
               (False, Q_SR, 8, "motion_search_only", 225))
# A child launches the kernel on a reference plane holding 256 and must
# fail: the packed samples are exact only for 0..255, so the kernel traps.
TRAP_CHILD = """
import torch
from vcp_tpu_torch.ops import motion_cuda
cur = torch.full((64, 64), 100, dtype=torch.int32, device="cuda")
ref = cur.clone()
motion_cuda.motion_search(cur, ref, 8, 4)
torch.cuda.synchronize()
print("in range: ok", flush=True)
ref[17, 33] = 256
motion_cuda.motion_search(cur, ref, 8, 4)
torch.cuda.synchronize()
print("out of range: no fault", flush=True)
"""


def _motion_contents(h, w, seed):
    """(name, cur, ref) numpy planes: shifted texture with noise, flat
    32x32 blocks moved by (8, 5), all 0, all 255, and a 0/255
    checkerboard against its inverse (every difference 255)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 23.0) * np.cos(yy / 31.0)).astype(np.int32)
    noisy_cur = np.clip(base + rng.integers(-20, 21, (h, w)), 0, 255)
    noisy_ref = np.clip(np.roll(noisy_cur, (3, -2), (0, 1))
                        + rng.integers(-3, 4, (h, w)), 0, 255)
    blocks = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1))
    flat_cur = np.repeat(np.repeat(blocks, 32, 0), 32, 1)[:h, :w]
    checker = 255 * ((yy + xx) % 2)
    return [("shifted+noise", noisy_cur, noisy_ref),
            ("flat", flat_cur, np.roll(flat_cur, (8, 5), (0, 1))),
            ("all 0", np.zeros((h, w)), np.zeros((h, w))),
            ("all 255", np.full((h, w), 255), np.full((h, w), 255)),
            ("checkerboard", checker, 255 - checker)]


def _motion_errs(cur, ref, sr, lam):
    """Max abs errors of the kernel, with the prediction and search-only,
    against the plain version and against the reference design."""
    from vcp_tpu_torch.ops import motion, motion_cuda
    mv_p, _ = motion.full_search(cur, ref, sr, lam)
    pred_p = motion.mc_luma(ref, mv_p, sr)
    mv_k = motion_cuda.motion_search(cur, ref, sr, lam)
    kp = motion_cuda.motion_search(cur, ref, sr, lam, with_pred=True)
    mv_r = motion_cuda.motion_search_ref(cur, ref, sr, lam)
    rp = motion_cuda.motion_search_ref(cur, ref, sr, lam, with_pred=True)
    return {True: max(max_abs_err(kp, (mv_p, pred_p)), max_abs_err(kp, rp)),
            False: max(max_abs_err((mv_k,), (mv_p,)),
                       max_abs_err((mv_k,), (mv_r,)))}


def motion_random_pairs(dev, h, w, n):
    """``n`` seeded random (cur, ref) pairs, the kernel against the
    reference design: uniform noise, three levels (many ties) and shifted
    copies with a little noise (exact matches), at every range of the
    effort ladder and some odd ones the wrapper also takes (the window
    starts off a word and 2 sr + 1 is 3 mod 4), lam 0 / 4 / 22 / 1000,
    both instantiations."""
    from vcp_tpu_torch.ops import motion_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def randint(lo, hi, shape=(h, w)):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    bad = 0
    srs = (4, 6, 8, 12, 16, 24, 1, 3, 5, 7, 9, 31)
    for i in range(n):     # every (range, lam, prediction) for each kind
        sr = srs[i % len(srs)]
        lam = (0, 4, 22, 1000)[i // len(srs) % 4]
        with_pred = i // (4 * len(srs)) % 2 == 0
        kind = i // (8 * len(srs)) % 3
        if kind == 0:
            cur, ref = randint(0, 256), randint(0, 256)
        elif kind == 1:
            cur, ref = randint(0, 3) * 127 + 1, randint(0, 3) * 127 + 1
        else:
            cur = randint(0, 256)
            dy, dx = (int(v) for v in randint(-30, 31, (2,)))
            ref = (torch.roll(cur, (dy, dx), (0, 1))
                   + randint(-2, 3)).clamp_(0, 255)
        got = motion_cuda.motion_search(cur, ref, sr, lam, with_pred)
        want = motion_cuda.motion_search_ref(cur, ref, sr, lam, with_pred)
        bad += max_abs_err(*((got, want) if with_pred
                             else ((got,), (want,))))
    return bad


def check_motion_trap() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", TRAP_CHILD], cwd=here,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    errors = [ln for ln in out.stderr.splitlines() if "error" in ln.lower()]
    log(f"  range trap: child exit {out.returncode}, stdout "
        f"{out.stdout.strip().splitlines()}, first error line "
        f"{(errors or [''])[0]!r}")
    if "in range: ok" not in out.stdout or out.returncode == 0 \
            or "no fault" in out.stdout:
        raise AssertionError("motion_search did not fail on a sample of "
                             "256")


def check_motion(dev, h, w, reps):
    """Both instantiations of the search kernel against the plain version
    and the reference design (the per-MB kernel of the first slice):
    every content of ``_motion_contents`` at every range and lam at
    1088x1920, two contents at every range at the stress shapes, a few
    hundred random pairs, and the range trap. Then the rows: the kernel's
    time alone beside the reference design's, plain time, pixel-offsets
    per SM clock and the bound at the best measured exact SAD sequence
    rate."""
    from vcp_tpu_torch.ops import motion, motion_cuda
    from vcp_tpu_torch.tools import probe_motion
    errs = {True: 0, False: 0}          # by with_pred
    t0 = time.monotonic()
    for hh, ww, contents, lams in (
            (h, w, None, MOTION_LAMS),
            *((sh, sw, ("shifted+noise", "checkerboard"), (22,))
              for sh, sw in MOTION_SHAPES)):
        for name, c, r in _motion_contents(hh, ww, 1):
            if contents and name not in contents:
                continue
            cur = torch.as_tensor(c, dtype=torch.int32, device=dev)
            ref = torch.as_tensor(r, dtype=torch.int32, device=dev)
            worst = {True: 0, False: 0}
            for sr in MOTION_SRS:
                for lam in lams:
                    e = _motion_errs(cur, ref, sr, lam)
                    for k in e:
                        worst[k] = max(worst[k], e[k])
            log(f"  motion_search {hh}x{ww} {name}, sr {MOTION_SRS}, lam "
                f"{lams}: max_abs_err {worst[True]} with pred, "
                f"{worst[False]} search only (against plain and reference)")
            for k in errs:
                errs[k] = max(errs[k], worst[k])
    if errs[True] or errs[False]:
        raise AssertionError(f"motion_search disagrees (max err {errs})")
    n_rand = 300
    bad = motion_random_pairs(dev, h, w, n_rand)
    log(f"  motion_search: {n_rand} random pairs at {h}x{w} against the "
        f"reference design: max_abs_err {bad} "
        f"({time.monotonic() - t0:.1f} s for the checks)")
    if bad:
        raise AssertionError(f"motion_search disagrees with the reference "
                             f"design on random pairs ({bad})")
    check_motion_trap()

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rates = probe_motion.sequence_rates(dev)
    names = [n for n, _ in probe_motion.SEQUENCES[:probe_motion.SAD_SEQUENCES]]
    best_seq = max(names, key=rates.get)
    cur, ref = probe_motion.test_planes(dev, h, w)
    clocks = probe_motion.sm_clocks_mhz(
        lambda: motion_cuda.motion_search(cur, ref, 8, 22))
    per_clk = {k: probe_motion.per_sm_clock(v, n_sm, clocks["under_load"])
               for k, v in rates.items()}
    log(f"  SAD sequences, pixel-offsets per SM clock at "
        f"{clocks['under_load']} MHz: {per_clk}")
    big = probe_motion.test_planes(dev, *STRESS_SHAPES[-1])
    rows = []
    for with_pred, sr, lam, name, line in MOTION_ROWS:
        def kern(c=cur, r=ref):
            return motion_cuda.motion_search(c, r, sr, lam, with_pred)

        def old(c=cur, r=ref):
            return motion_cuda.motion_search_ref(c, r, sr, lam, with_pred)

        def plain():
            mv = motion.full_search(cur, ref, sr, lam)[0]
            return motion.mc_luma(ref, mv, sr) if with_pred else mv
        ms, ref_ms = probe_motion.device_ms(kern), probe_motion.device_ms(old)
        plain_ms = time_ms(plain, dev, max(1, reps // 10))
        ms_big = probe_motion.device_ms(lambda: kern(*big))
        ref_ms_big = probe_motion.device_ms(lambda: old(*big))
        bnd = probe_motion.bound(h, w, sr, with_pred, rates[best_seq])

        def po_clk(t, hh=h, ww=w):
            return probe_motion.per_sm_clock(
                probe_motion.work(hh, ww, sr) / (t * 1e-3), n_sm,
                clocks["under_load"])
        row = {"name": name, "route": "cuda",
               "source": "vcp_tpu_torch/csrc/motion_search.cu",
               "replaces": f"vcp_tpu/ops/motion_pallas.py:{line}",
               "max_abs_err": errs[with_pred], "ms": ms,
               "plain_ms": plain_ms, **bnd, "library_ms": None,
               "ref_ms": ref_ms, "search_range": sr, "lam": lam,
               "po_per_sm_clock": po_clk(ms),
               "ref_po_per_sm_clock": po_clk(ref_ms),
               "bound_sequence": best_seq,
               "bound_po_per_sm_clock": per_clk[best_seq],
               "sm_clock_mhz": clocks["under_load"],
               "plan": motion_cuda.launch_plan(h, w, sr, dev),
               "ms_2160x3840": ms_big, "ref_ms_2160x3840": ref_ms_big,
               "po_per_sm_clock_2160x3840": po_clk(ms_big,
                                                   *STRESS_SHAPES[-1]),
               "bound_ms_2160x3840": probe_motion.bound(
                   *STRESS_SHAPES[-1], sr, with_pred,
                   rates[best_seq])["bound_ms"]}
        if not ms < ref_ms or not ms_big < ref_ms_big:
            raise AssertionError(f"{name}: {ms:.4f} / {ms_big:.4f} ms, the "
                                 f"reference design {ref_ms:.4f} / "
                                 f"{ref_ms_big:.4f} ms")
        if ms < row["bound_ms"] or ms_big < row["bound_ms_2160x3840"]:
            raise AssertionError(f"{name}: a time below its bound: {row}")
        rows.append(row)
    return rows



MESH_TILES = (2, 4)          # bands of the tile mesh on one card


def check_motion_bands(dev, h, w) -> dict:
    """The band form of both instantiations (the tile mesh's P step):
    every band of an h x w frame cut into 2 and into 4, at frame row
    ``row0`` against the whole reference, held against the plain
    ``full_search`` / ``mc_luma`` with ``row0`` on two contents (shifted
    texture with noise; the checkerboard, every difference 255); and the
    device ms of one band launch (the median band) for the rows, beside
    the whole frame's. Returns name -> fields of the kernel row."""
    from vcp_tpu_torch.ops import motion, motion_cuda
    from vcp_tpu_torch.tools import probe_motion
    contents = [(c, r) for name, c, r in _motion_contents(h, w, 2)
                if name in ("shifted+noise", "checkerboard")]
    out = {}
    for with_pred, sr, lam, name, _ in MOTION_ROWS:
        err, band_ms, plans = 0, {}, {}
        for n_tile in MESH_TILES:
            hb = h // n_tile
            for c, r in contents:
                cur = torch.as_tensor(c, dtype=torch.int32, device=dev)
                ref = torch.as_tensor(r, dtype=torch.int32, device=dev)
                for t in range(n_tile):
                    band = cur[t * hb:(t + 1) * hb].contiguous()
                    got = motion_cuda.motion_search(band, ref, sr, lam,
                                                    with_pred, row0=t * hb)
                    mv = motion.full_search(band, ref, sr, lam, t * hb)[0]
                    err = max(err, max_abs_err(
                        got if with_pred else (got,),
                        (mv, motion.mc_luma(ref, mv, sr, t * hb))
                        if with_pred else (mv,)))
            cur, ref = probe_motion.test_planes(dev, h, w)
            band_ms[str(n_tile)] = statistics.median(
                probe_motion.device_ms(
                    lambda b=cur[t * hb:(t + 1) * hb].contiguous(), t=t:
                    motion_cuda.motion_search(b, ref, sr, lam, with_pred,
                                              row0=t * hb))
                for t in range(n_tile))
            plans[str(n_tile)] = motion_cuda.launch_plan(hb, w, sr, dev)
        log(f"  {name} bands of {h}x{w} at sr {sr} (row0 against the whole "
            f"reference, 2 contents): max_abs_err {err} against full_search"
            f" / mc_luma with row0; ms per band launch {band_ms} "
            f"(2 / 4 bands), plans {plans}")
        if err:
            raise AssertionError(f"{name}: a band disagrees (max err {err})")
        out[name] = {"band_max_abs_err": err, "band_ms": band_ms,
                     "band_plan": plans}
    return out

def _deblock_planes(rng, h, w):
    """Smooth content with 4x4 blocking steps, where the filters fire."""
    def plane(hh, ww):
        yy, xx = np.mgrid[0:hh, 0:ww]
        base = 100 + (xx * 60) // ww + (yy * 40) // hh
        steps = np.repeat(np.repeat(
            rng.integers(-6, 7, (hh // 4, ww // 4)), 4, 0), 4, 1)
        return np.clip(base + steps + rng.integers(-2, 3, (hh, ww)), 0, 255)
    return plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)


def _filtered_lines(bs_v, bs_h):
    """Edge lines the data makes the filter visit (bS > 0): luma lines
    (4 per block edge) and chroma lines (2 planes x 2 per luma block
    edge on the 8-px grid)."""
    luma = 4 * (int((bs_v > 0).sum()) + int((bs_h > 0).sum()))
    chroma = 2 * 2 * (int((bs_v[1::2] > 0).sum()) + int((bs_h[1::2] > 0)
                                                         .sum()))
    return luma, chroma


def _deblock_row(name, line, dev, reps, planes, err, kernel, diag, plain,
                 grid_bytes, nops):
    """Times of one deblock kernel (the wrapper call), of the per-diagonal
    reference and of the plain version on the same inputs, and the bound:
    each plane read and written once plus the edge grids, or the filter
    operations this data needs."""
    y, u, v = planes
    h, w = y.shape
    if max_abs_err(kernel(), diag()):
        raise AssertionError(f"{name}: the per-diagonal reference "
                             f"disagrees with the kernel")
    ms = time_ms(kernel, dev, reps)
    diag_ms = time_ms(diag, dev, reps)
    if not ms < diag_ms:
        raise AssertionError(f"{name}: one launch takes {ms:.4f} ms, the "
                             f"per-diagonal reference {diag_ms:.4f} ms")
    plain_ms = time_ms(plain, dev, max(1, reps // 10))
    d_steps = w // 16 + 2 * (h // 16 - 1)
    nbytes = 2 * (y.numel() + u.numel() + v.numel()) * 4 + grid_bytes
    bms, by = bound_ms(nbytes, nops)
    return {"name": name, "route": "cuda",
            "source": "vcp_tpu_torch/csrc/deblock.cu",
            "replaces": f"vcp_tpu/ops/deblock_pallas.py:{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "diag_ms": diag_ms, "d_steps": d_steps,
            "step_us": ms * 1e3 / d_steps}


def check_deblock_fast(dev, h, w, reps):
    from vcp_tpu_torch.ops import deblock, deblock_cuda
    rng = np.random.default_rng(2)
    n_mby, n_mbx = h // 16, w // 16
    err = 0
    last = None
    for qp in (22, 30, 40):
        for density in (0.0, 0.05, 0.5):
            y, u, v = (torch.as_tensor(p, dtype=torch.int32, device=dev)
                       for p in _deblock_planes(rng, h, w))
            intra = torch.zeros((n_mby, n_mbx), dtype=torch.bool, device=dev)
            nz = torch.as_tensor(rng.random((h // 4, w // 4)) < density,
                                 device=dev)
            mv = torch.as_tensor(
                (rng.random((n_mby, n_mbx, 1)) < max(density, 0.2))
                * rng.integers(-8, 9, (n_mby, n_mbx, 2)), dtype=torch.int32,
                device=dev)
            bs_v = deblock.compute_bs_luma(intra, nz, mv, True)
            bs_h = deblock.compute_bs_luma(intra, nz, mv, False)
            scal = deblock.deblock_scalars(qp)
            ref = deblock.deblock_fast_plain(y, u, v, bs_v, bs_h, scal)
            out = deblock_cuda.deblock_fast(y, u, v, bs_v, bs_h, scal)
            e = max_abs_err(out, ref)
            changed = int((ref[0] != y).sum())
            log(f"  deblock_fast qp={qp} density={density}: max_abs_err "
                f"{e} (luma samples changed {changed})")
            err = max(err, e)
            last = (y, u, v, bs_v, bs_h, scal)
    if err:
        raise AssertionError(f"deblock_fast disagrees (max err {err})")
    y, u, v, bs_v, bs_h, scal = last
    luma, chroma = _filtered_lines(bs_v, bs_h)
    return _deblock_row(
        "deblock_fast", 364, dev, reps, (y, u, v), err,
        lambda: deblock_cuda.deblock_fast(y, u, v, bs_v, bs_h, scal),
        lambda: deblock_cuda.deblock_fast_diag(y, u, v, bs_v, bs_h, scal),
        lambda: deblock.deblock_fast_plain(y, u, v, bs_v, bs_h, scal),
        (bs_v.numel() + bs_h.numel()) * 4, luma * 35 + chroma * 20)


def check_deblock_general(dev, h, w, reps):
    from vcp_tpu_torch.ops import deblock, deblock_cuda
    rng = np.random.default_rng(3)
    n_mby, n_mbx = h // 16, w // 16
    y, u, v = (torch.as_tensor(p, dtype=torch.int32, device=dev)
               for p in _deblock_planes(rng, h, w))
    intra = torch.ones((n_mby, n_mbx), dtype=torch.bool, device=dev)
    nz = torch.zeros((h // 4, w // 4), dtype=torch.bool, device=dev)
    mv = torch.zeros((n_mby, n_mbx, 2), dtype=torch.int32, device=dev)
    qp_mb = torch.as_tensor(rng.integers(18, 46, (n_mby, n_mbx)),
                            dtype=torch.int32, device=dev)
    bs_v = deblock.compute_bs_luma(intra, nz, mv, True)
    bs_h = deblock.compute_bs_luma(intra, nz, mv, False)
    grids = deblock.threshold_grids(bs_v, bs_h, qp_mb)
    ref = deblock.deblock_general_plain(y, u, v, *grids, strong=True)
    out = deblock_cuda.deblock_general(y, u, v, *grids, strong=True)
    err = max_abs_err(out, ref)
    log(f"  deblock_general intra bS 3/4: max_abs_err {err} "
        f"(luma samples changed {int((ref[0] != y).sum())})")
    if err:
        raise AssertionError(f"deblock_general disagrees (max err {err})")
    luma, chroma = _filtered_lines(bs_v, bs_h)
    return _deblock_row(
        "deblock_general", 424, dev, reps, (y, u, v), err,
        lambda: deblock_cuda.deblock_general(y, u, v, *grids, strong=True),
        lambda: deblock_cuda.deblock_general_diag(y, u, v, *grids,
                                                  strong=True),
        lambda: deblock.deblock_general_plain(y, u, v, *grids, strong=True),
        sum(g.numel() for g in grids) * 4, luma * 50 + chroma * 20)


def check_deblock_general_no_strong(dev, h, w, reps):
    """The strong=False instantiation on an all-inter frame (bS <= 3)
    whose QP differs from MB to MB, the case deblock_fast cannot take."""
    from vcp_tpu_torch.ops import deblock, deblock_cuda
    rng = np.random.default_rng(4)
    n_mby, n_mbx = h // 16, w // 16
    y, u, v = (torch.as_tensor(p, dtype=torch.int32, device=dev)
               for p in _deblock_planes(rng, h, w))
    intra = torch.zeros((n_mby, n_mbx), dtype=torch.bool, device=dev)
    nz = torch.as_tensor(rng.random((h // 4, w // 4)) < 0.3, device=dev)
    mv = torch.as_tensor(
        (rng.random((n_mby, n_mbx, 1)) < 0.3)
        * rng.integers(-8, 9, (n_mby, n_mbx, 2)), dtype=torch.int32,
        device=dev)
    qp_mb = torch.as_tensor(rng.integers(20, 45, (n_mby, n_mbx)),
                            dtype=torch.int32, device=dev)
    bs_v = deblock.compute_bs_luma(intra, nz, mv, True)
    bs_h = deblock.compute_bs_luma(intra, nz, mv, False)
    if int(max(bs_v.max(), bs_h.max())) > 3 or len(qp_mb.unique()) < 2:
        raise AssertionError("inputs must be bS <= 3 with non-uniform QP")
    grids = deblock.threshold_grids(bs_v, bs_h, qp_mb)
    ref = deblock.deblock_general_plain(y, u, v, *grids, strong=False)
    out = deblock_cuda.deblock_general(y, u, v, *grids, strong=False)
    err = max_abs_err(out, ref)
    log(f"  deblock_general strong=False, per-MB QP, bS <= 3: max_abs_err "
        f"{err} (luma samples changed {int((ref[0] != y).sum())})")
    if err:
        raise AssertionError(f"deblock_general(strong=False) disagrees "
                             f"(max err {err})")
    luma, chroma = _filtered_lines(bs_v, bs_h)
    row = _deblock_row(
        "deblock_general_no_strong", 424, dev, reps, (y, u, v), err,
        lambda: deblock_cuda.deblock_general(y, u, v, *grids, strong=False),
        lambda: deblock_cuda.deblock_general_diag(y, u, v, *grids,
                                                  strong=False),
        lambda: deblock.deblock_general_plain(y, u, v, *grids,
                                              strong=False),
        sum(g.numel() for g in grids) * 4, luma * 35 + chroma * 20)
    row["note"] = ("strong=False; its one caller is the tile mesh's P "
                   "step (phase 3f), which deblocks the gathered planes "
                   "without a scalar QP")
    return row


def check_deblock_shapes(dev, shapes=STRESS_SHAPES):
    """Shapes that stress the schedule of the one-launch kernels, each
    against the plain version once: a single MB row, a single MB column,
    and 2160p, which has more MB rows (135) than the card has SMs."""
    from vcp_tpu_torch.ops import deblock, deblock_cuda
    rng = np.random.default_rng(5)
    for h, w in shapes:
        n_mby, n_mbx = h // 16, w // 16
        y, u, v = (torch.as_tensor(p, dtype=torch.int32, device=dev)
                   for p in _deblock_planes(rng, h, w))
        nz = torch.as_tensor(rng.random((h // 4, w // 4)) < 0.3, device=dev)
        mv = torch.as_tensor(
            (rng.random((n_mby, n_mbx, 1)) < 0.3)
            * rng.integers(-8, 9, (n_mby, n_mbx, 2)), dtype=torch.int32,
            device=dev)
        qp_mb = torch.as_tensor(rng.integers(24, 46, (n_mby, n_mbx)),
                                dtype=torch.int32, device=dev)
        for name, all_intra in (("deblock_fast", False),
                                ("deblock_general strong=True", True)):
            intra = torch.full((n_mby, n_mbx), all_intra, device=dev)
            bs_v = deblock.compute_bs_luma(intra, nz, mv, True)
            bs_h = deblock.compute_bs_luma(intra, nz, mv, False)
            t0 = time.monotonic()
            if all_intra:
                grids = deblock.threshold_grids(bs_v, bs_h, qp_mb)
                ref = deblock.deblock_general_plain(y, u, v, *grids)
                out = deblock_cuda.deblock_general(y, u, v, *grids)
            else:
                scal = deblock.deblock_scalars(34)
                ref = deblock.deblock_fast_plain(y, u, v, bs_v, bs_h, scal)
                out = deblock_cuda.deblock_fast(y, u, v, bs_v, bs_h, scal)
            e = max_abs_err(out, ref)
            log(f"  {name} {h}x{w}: max_abs_err {e} (luma samples changed "
                f"{int((ref[0] != y).sum())}, {time.monotonic() - t0:.1f} s)")
            if e:
                raise AssertionError(f"{name} disagrees at {h}x{w} "
                                     f"(max err {e})")


def _busy_stream(dev, n: int):
    """Queue ``n`` large matrix products on a side stream, so that the
    kernels launched meanwhile find the card occupied and their blocks
    are not all resident at once."""
    side = torch.cuda.Stream(dev)
    a = torch.ones((4096, 4096), device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(n):
            a @ a
    return side


def race_hunt(dev, h, w, n_random: int = 200, n_repeat: int = 50):
    """The one-launch kernels against the per-diagonal reference kernels,
    exact equality: for each instantiation ``n_random`` calls on fresh
    random frames (content, QP, residual density and intra share drawn
    per call on the card, some frames with every bS 0) and ``n_repeat``
    calls on one frame that must all return the same planes. The second
    half of each runs beside a busy side stream."""
    from vcp_tpu_torch.ops import deblock, deblock_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    n_mby, n_mbx = h // 16, w // 16
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    base = (100 + (xx * 60) // w + (yy * 40) // h).to(torch.int32)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def plane(b):
        hh, ww = b.shape
        steps = randint(-6, 7, (hh // 4, ww // 4)) \
            .repeat_interleave(4, 0).repeat_interleave(4, 1)
        return (b + steps + randint(-2, 3, (hh, ww))).clamp_(0, 255)

    def draw(mode: int, i: int):
        """Inputs of call ``i`` as (kernel call, reference call)."""
        dens = (0.0, 0.0, 0.02, 0.1, 0.3, 0.6, 1.0)[i % 7]
        empty = i % 7 == 0                     # every bS 0
        y, u, v = plane(base), plane(base[::2, ::2]), plane(base[::2, ::2])
        nz = rand((h // 4, w // 4)) < dens
        mv = randint(-8, 9, (n_mby, n_mbx, 2)) \
            * (rand((n_mby, n_mbx, 1)) < (0.0 if empty else 0.3))
        p_intra = (0.0, 0.1, 0.5, 1.0)[i % 4] if mode == 2 and not empty \
            else 0.0
        intra = rand((n_mby, n_mbx)) < p_intra
        bs_v = deblock.compute_bs_luma(intra, nz, mv, True)
        bs_h = deblock.compute_bs_luma(intra, nz, mv, False)
        if mode == 0:
            a = (y, u, v, bs_v, bs_h, deblock.deblock_scalars(20 + i % 30))
            return (lambda: deblock_cuda.deblock_fast(*a),
                    lambda: deblock_cuda.deblock_fast_diag(*a))
        qp_mb = randint(16, 48, (n_mby, n_mbx))
        a = (y, u, v, *deblock.threshold_grids(bs_v, bs_h, qp_mb))
        return (lambda: deblock_cuda.deblock_general(*a, strong=mode == 2),
                lambda: deblock_cuda.deblock_general_diag(
                    *a, strong=mode == 2))

    for mode, name in ((0, "deblock_fast"), (1, "deblock_general "
                       "strong=False"), (2, "deblock_general strong=True")):
        t0 = time.monotonic()
        bad = 0
        for i in range(n_random):
            side = _busy_stream(dev, 2) if i >= n_random // 2 else None
            kernel, reference = draw(mode, i)
            out, ref = kernel(), reference()
            bad += sum(int((a != b).sum()) for a, b in zip(out, ref))
            if side is not None:
                side.synchronize()
        kernel, reference = draw(mode, 5)
        ref = reference()
        for i in range(n_repeat):
            side = _busy_stream(dev, 2) if i >= n_repeat // 2 else None
            bad += sum(int((a != b).sum()) for a, b in zip(kernel(), ref))
            if side is not None:
                side.synchronize()
        log(f"  race hunt {name} {h}x{w}: {n_random} random frames and "
            f"{n_repeat} repeats against the per-diagonal reference, half "
            f"beside a busy stream: {bad} differing samples "
            f"({time.monotonic() - t0:.1f} s)")
        if bad:
            raise AssertionError(f"{name}: {bad} samples differ from the "
                                 f"per-diagonal reference")


# ---------------------------------------------------------------------------
# Phase 3: the main paths through the CLI
# ---------------------------------------------------------------------------

def synth_frames(h: int, w: int, n: int, cut: int, seed: int = 0):
    """Moving smooth gradient + texture, a scene cut at frame ``cut``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float32)
    frames = []
    for t in range(n):
        second = t >= cut
        dx, dy = 3.0 * t, 1.0 * t
        y = (70 + 0.05 * (xx + dx) + 0.04 * (yy + dy)
             + 35 * np.sin((xx + dx) / 41.0) * np.cos((yy + dy) / 29.0))
        if second:
            y = 255 - y
        y = y + rng.integers(-2, 3, (h, w))
        u = 128 + 30 * np.sin((cx + dx / 2) / 37.0)
        v = 128 + 30 * np.cos((cy + dy / 2) / 23.0) * (-1 if second else 1)
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, u, v)))
    return frames


def gop_cts(n: int, b: int) -> list[int]:
    """Composition offsets (frames) of one GOP of n frames in decode
    order: anchors every b+1 display frames and on the last one, B
    pictures after the anchor that follows them."""
    if b == 0 or n <= 2:
        return [0] * n
    anchors = list(range(0, n, b + 1))
    if anchors[-1] != n - 1:
        anchors.append(n - 1)
    order = [0]
    for prev, a in zip(anchors, anchors[1:]):
        order += [a, *range(prev + 1, a)]
    return [disp - dec + 1 for dec, disp in enumerate(order)]


def check_mp4(path: str, n_frames: int, idrs: list[int],
              cts: list[int] | None = None,
              fps: tuple[int, int] = (30, 1), faststart: bool = True,
              entry: bytes = b"avc1") -> None:
    """Top-level boxes (moov first with ``faststart``), sample count,
    sample entry (``entry``, with its avcC / hvcC box), sync samples, a
    frame duration of 1 / ``fps`` (num,
    den) and the ctts box: present with these per-sample composition
    offsets (frames) when ``cts`` is given, absent otherwise."""
    import struct
    from vcp_tpu_torch.codec import mp4
    with open(path, "rb") as fh:
        buf = fh.read()
    top = [t for t, _, _ in mp4.iter_boxes(buf)]
    if top != [b"ftyp", *((b"moov", b"mdat") if faststart
                          else (b"mdat", b"moov"))]:
        raise AssertionError(f"top-level boxes {top}")
    stbl = [b"moov", b"trak", b"mdia", b"minf", b"stbl"]
    ps, _ = mp4.find_box(buf, stbl + [b"stsz"])
    count = struct.unpack_from(">I", buf, ps + 8)[0]
    if count != n_frames:
        raise AssertionError(f"{count} samples, expected {n_frames}")
    ps, pe = mp4.find_box(buf, stbl + [b"stsd"])
    entries = list(mp4.iter_boxes(buf, ps + 8, pe))
    if [t for t, _, _ in entries] != [entry]:
        raise AssertionError(f"sample entries {entries}, expected {entry}")
    cfg = {b"avc1": b"avcC", b"hvc1": b"hvcC"}[entry]
    # the visual sample entry's own fields take 78 bytes
    if mp4.find_box(buf, [cfg], entries[0][1] + 78, entries[0][2]) is None:
        raise AssertionError(f"no {cfg} box in the {entry} sample entry")
    stss = mp4.find_box(buf, stbl + [b"stss"])
    if stss is None:                   # no stss: every sample is a sync
        sync = list(range(count))
    else:
        ps = stss[0]
        n_sync = struct.unpack_from(">I", buf, ps + 4)[0]
        sync = [struct.unpack_from(">I", buf, ps + 8 + 4 * i)[0] - 1
                for i in range(n_sync)]
    if sync != idrs:
        raise AssertionError(f"sync samples {sync}, expected IDRs {idrs}")
    # ticks per frame: the first stts run's sample delta, which must be
    # the track timescale over the frame rate (an MP4 input sets the
    # output's timescale)
    ps, _ = mp4.find_box(buf, [b"moov", b"trak", b"mdia", b"mdhd"])
    timescale = struct.unpack_from(">I", buf, ps + 12)[0]
    dur = struct.unpack_from(">I", buf,
                             mp4.find_box(buf, stbl + [b"stts"])[0] + 12)[0]
    if dur * fps[0] != timescale * fps[1]:
        raise AssertionError(f"stts delta {dur} at timescale {timescale}, "
                             f"expected {fps[0]}/{fps[1]} fps")
    box = mp4.find_box(buf, stbl + [b"ctts"])
    got = None
    if box is not None:
        ps, _ = box
        got = []
        for i in range(struct.unpack_from(">I", buf, ps + 4)[0]):
            n, off = struct.unpack_from(">II", buf, ps + 8 + 8 * i)
            got += [off // dur] * n
    if got != cts:
        raise AssertionError(f"composition offsets {got}, expected {cts}")
    log(f"  mp4: boxes {[t.decode() for t in top]}, {count} samples, "
        f"sync samples {sync}, composition offsets {got}")


def synth_frames_subpel(h: int, w: int, n: int, cut: int, seed: int = 1):
    """A gradient half and a texture half that move by a fractional number
    of pixels per frame (1.5 across, 0.5 down), plus noise, so half-pel
    vectors win and i8 / I16 and both transforms each win somewhere;
    inverted from frame ``cut`` on (a scene cut)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float32)
    frames = []
    for t in range(n):
        x, yv = xx + 1.5 * t, yy + 0.5 * t
        grad = 60 + 0.05 * x + 0.04 * yv + 20 * np.sin(x / 67.0)
        tex = 128 + 60 * np.sin(x / 2.9) * np.cos(yv / 3.7)
        y = np.where(xx < w // 2, grad, tex) + rng.integers(-3, 4, (h, w))
        u = 128 + 30 * np.sin((cx + 0.75 * t) / 37.0)
        v = 128 + 30 * np.cos((cy + 0.25 * t) / 23.0)
        f = tuple(np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v))
        frames.append(tuple(255 - p for p in f) if t >= cut else f)
    return frames


def launch_counters() -> dict:
    """name -> (object, attribute) of every kernel's launch count."""
    from vcp_tpu_torch.ops import deblock_cuda, motion_cuda
    return {
        "motion_search": (motion_cuda.motion_search, "launches_with_pred"),
        "motion_search_only": (motion_cuda.motion_search,
                               "launches_search_only"),
        "deblock_fast": (deblock_cuda.deblock_fast, "launches"),
        "deblock_general": (deblock_cuda.deblock_general, "launches"),
        "deblock_general_no_strong": (deblock_cuda.deblock_general,
                                      "launches_no_strong"),
    }


def _count(seen: dict, key: str, n) -> None:
    seen[key] = seen.get(key, 0) + int(n)


@contextlib.contextmanager
def observe_encoder(seen: dict):
    """While active, record what the CLI's encoder does without changing
    it: the encoder objects (for ``stage_s``), the share of i8 MBs of
    every IDR, the t8 MBs, half-pel vectors, intra MBs and partitioned
    MBs of every P slice, the MBs of each B mode and the B MBs without
    residual of every B slice, the vectors of P and B slices and those
    with a quarter phase, per P anchor the intra overlay's gate
    and the host seconds of the partition search and of the overlay (its
    dispatch: the device runs behind), per IDR the host seconds of the RD
    intra frame's dispatch (``encode_iframe_rd`` or ``encode_iframe_rd8``),
    the host seconds of each Python CAVLC slice writer call
    (``cavlc_writer.write_pslice`` / ``write_bslice``), and the host
    seconds of each ``audio_track_for`` (AAC decode and encode, or PCM
    encode); for HEVC
    the encoder objects, the host seconds of each
    ``syntax.encode_slice_data`` (the pure-Python CABAC), the vectors of
    P slices and those with a quarter phase, and the CTUs of IDRs with a
    left-dependent luma mode (planar, or angular below 26)."""
    from vcp_tpu_torch.codec import audio
    from vcp_tpu_torch.codec.h264 import (bframe, cavlc_writer, encoder,
                                          entropy, intra_rd, pframe)
    from vcp_tpu_torch.codec.h265 import encoder as h265enc
    from vcp_tpu_torch.codec.h265 import syntax as h265syn
    from vcp_tpu_torch.ops import motion
    real_enc = encoder.H264Encoder
    real_henc = h265enc.HevcEncoder
    real_hslice = h265syn.encode_slice_data
    real_i, real_p = entropy.write_islice, entropy.write_pslice
    real_b = bframe.write_bslice
    timed = [(motion, "full_search_parts"), (motion, "hier_search_parts"),
             (intra_rd, "intra_overlay_pass"), (pframe, "_overlay_gate"),
             (audio, "audio_track_for"), (intra_rd, "encode_iframe_rd"),
             (intra_rd, "encode_iframe_rd8"),
             (cavlc_writer, "write_pslice"), (cavlc_writer, "write_bslice")]
    real_timed = [getattr(m, k) for m, k in timed]

    def timer(key, fn):
        def call(*a, **kw):
            t = time.monotonic()
            out = fn(*a, **kw)
            seen.setdefault(key, []).append(
                out if key == "_overlay_gate" else time.monotonic() - t)
            return out
        return call

    class Observed(real_enc):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.setdefault("encoders", []).append(self)

    class ObservedHevc(real_henc):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.setdefault("encoders", []).append(self)

    def hslice(qp, is_idr, ly, lu, lv, mv, modes=None):
        t = time.monotonic()
        out = real_hslice(qp, is_idr, ly, lu, lv, mv, modes=modes)
        seen.setdefault("hevc_cabac_s", []).append(time.monotonic() - t)
        if mv is not None:
            vectors(mv)
        if modes is not None:
            m = np.asarray(modes)
            _count(seen, "idr_ctus", m.size)
            _count(seen, "left_mode_ctus", ((m == 0) | ((m >= 2)
                                                        & (m < 26))).sum())
        return out

    def islice(*a, **kw):
        i8 = kw["data"].get("i8")
        seen.setdefault("i8_share", []).append(
            0.0 if i8 is None else float(np.mean(i8)))
        modes = kw["data"].get("modes")
        if modes is not None and i8 is None:
            seen.setdefault("idr_modes", []).append(
                np.bincount(np.asarray(modes).ravel(), minlength=4)
                .tolist())
        return real_i(*a, **kw)

    def vectors(mv):
        """Count the vectors of a grid and those with an odd (quarter)
        phase in either component."""
        _count(seen, "mvs", mv[..., 0].size)
        _count(seen, "quarter_pel_mvs", ((mv & 1) == 1).any(axis=-1).sum())

    def pslice(*a, **kw):
        d = kw["data"]
        _count(seen, "t8_mbs", d["t8"].sum() if "t8" in d else 0)
        _count(seen, "half_pel_mvs", ((d["mv"] & 3) == 2).any(axis=-1).sum())
        vectors(d["mv8"] if "mv8" in d else d["mv"])
        _count(seen, "p_intra_mbs", d["intra"].sum() if "intra" in d else 0)
        _count(seen, "p_part_mbs",
               (d["parts"] > 0).sum() if "parts" in d else 0)
        return real_p(*a, **kw)

    def bslice(*a, **kw):
        d = kw["data"]
        vectors(d["mv0"])
        vectors(d["mv1"])
        for m in range(3):
            _count(seen, f"b_mode{m}_mbs", (d["mode"] == m).sum())
        _count(seen, "b_no_residual_mbs", (
            (d["luma"] == 0).all(axis=(-1, -2))
            & (d["cb_dc"] == 0).all(-1) & (d["cr_dc"] == 0).all(-1)
            & (d["cb_ac"] == 0).all(axis=(-1, -2))
            & (d["cr_ac"] == 0).all(axis=(-1, -2))).sum())
        return real_b(*a, **kw)

    encoder.H264Encoder = Observed
    h265enc.HevcEncoder = ObservedHevc
    h265syn.encode_slice_data = hslice
    entropy.write_islice, entropy.write_pslice = islice, pslice
    bframe.write_bslice = bslice
    for (m, k), fn in zip(timed, real_timed):
        setattr(m, k, timer(k, fn))
    try:
        yield seen
    finally:
        encoder.H264Encoder = real_enc
        h265enc.HevcEncoder = real_henc
        h265syn.encode_slice_data = real_hslice
        entropy.write_islice, entropy.write_pslice = real_i, real_p
        bframe.write_bslice = real_b
        for (m, k), fn in zip(timed, real_timed):
            setattr(m, k, fn)


def run_main_path(label: str, frames, tmp: str, cli_args: list[str],
                  idrs: list[int], must_launch: tuple[str, ...],
                  env: dict | None = None, cts: list[int] | None = None,
                  src: str | None = None, faststart: bool = True,
                  entry: bytes = b"avc1") -> tuple[dict, dict]:
    """One CLI encode on cuda with every launch count set to 0 just before
    and read just after; returns (launches by kernel, what was seen). The
    input is ``frames`` written as a Y4M file, or the file ``src`` (then
    ``frames`` gives only the count and size). ``faststart``: the args
    carry ``-movflags +faststart``; ``entry``: the MP4's sample entry
    (``hvc1`` for HEVC)."""
    from vcp_tpu_torch import cli
    from vcp_tpu_torch.codec.y4m import write_y4m
    dst = os.path.join(tmp, f"{label}.mp4")
    if src is None:
        src = os.path.join(tmp, f"{label}.y4m")
        write_y4m(src, frames, 30, 1)
    counters = launch_counters()
    seen: dict = {}
    with scoped_env(env), observe_encoder(seen):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(["encode", src, dst, *cli_args, "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: getattr(fn, attr)
                    for k, (fn, attr) in counters.items()}
    if rc != 0:
        raise RuntimeError(f"cli encode exited {rc}")
    WALL_S[label] = wall
    stages = {k: round(sum(e.stage_s[k] for e in seen["encoders"]), 3)
              for k in seen["encoders"][0].stage_s}
    log(f"  {label}: {len(frames)} frames {frames[0][0].shape} in "
        f"{wall:.3f} s ({len(frames) / wall:.2f} fps), launches "
        f"{launches}, stage_s {stages}")
    missing = [k for k in must_launch if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path "
                             f"{label}: {missing}")
    check_mp4(dst, len(frames), idrs, cts, faststart=faststart,
              entry=entry)
    return launches, seen


def check_quality_tools(label: str, seen: dict) -> None:
    """The quality shape used what it adds: i8 and I16 MBs in an IDR, t8
    MBs and half-pel vectors in P slices."""
    log(f"  {label}: i8 share per IDR {seen['i8_share']}, t8 MBs "
        f"{seen['t8_mbs']}, MBs with a half-pel vector "
        f"{seen['half_pel_mvs']}")
    if not (any(0 < s for s in seen["i8_share"])
            and any(s < 1 for s in seen["i8_share"])):
        raise AssertionError("no IDR MB chose i8, or none chose I16")
    if not seen["t8_mbs"] > 0:
        raise AssertionError("no P MB chose the 8x8 transform")
    if not seen["half_pel_mvs"] > 0:
        raise AssertionError("no vector has a half-pel phase")


def check_qpel_tools(label: str, seen: dict) -> None:
    """The quarter-pel path coded quarter-pel vectors: the share of the
    P and B slices' vectors with an odd phase is above 0."""
    share = seen.get("quarter_pel_mvs", 0) / max(1, seen.get("mvs", 0))
    log(f"  {label}: vectors with a quarter-pel phase "
        f"{seen.get('quarter_pel_mvs', 0)} of {seen.get('mvs', 0)} "
        f"(share {share:.4f})")
    if not share > 0:
        raise AssertionError(f"{label}: no vector has a quarter-pel phase")


def check_decoder(path: str, source) -> list:
    """The port's host decoder on an MP4 the port wrote: every frame, in
    display order, close to the synthetic source. Returns the frames."""
    from vcp_tpu_torch.codec.h264.decoder import psnr
    from vcp_tpu_torch.codec.ingest import open_video
    t0 = time.monotonic()
    vid = open_video(path)
    frames = list(vid.frames)
    dt = time.monotonic() - t0
    if len(frames) != len(source):
        raise AssertionError(f"decoded {len(frames)} frames of "
                             f"{len(source)}")
    db = [psnr(f[0], s[0]) for f, s in zip(frames, source)]
    log(f"  host decode of {os.path.basename(path)}: {len(frames)} frames "
        f"{frames[0][0].shape} in {dt:.3f} s ({len(frames) / dt:.2f} fps), "
        f"luma PSNR vs the source min {min(db):.2f} dB, mean "
        f"{statistics.mean(db):.2f} dB (floor {DECODE_PSNR_FLOOR_DB})")
    if not min(db) >= DECODE_PSNR_FLOOR_DB:
        raise AssertionError(f"decoded luma PSNR {min(db):.2f} dB below "
                             "the floor: frames out of order or drifting")
    return frames


def check_b_tools(label: str, seen: dict) -> None:
    """The B-GOP quality path used what it adds: intra MBs in some P
    slice, partitioned MBs, all three B modes, B MBs without residual."""
    keys = ("p_intra_mbs", "p_part_mbs", "b_mode0_mbs", "b_mode1_mbs",
            "b_mode2_mbs", "b_no_residual_mbs")
    log(f"  {label}: " + ", ".join(f"{k} {seen.get(k, 0)}" for k in keys))
    log(f"  {label}: per P anchor: overlay gate {seen.get('_overlay_gate')}"
        ", host s of the overlay "
        f"{[round(t, 3) for t in seen.get('intra_overlay_pass', [])]}, of "
        "the partition search (pyramid "
        f"{[round(t, 3) for t in seen.get('hier_search_parts', [])]}, "
        "exhaustive "
        f"{[round(t, 3) for t in seen.get('full_search_parts', [])]})")
    missing = [k for k in keys if not seen.get(k, 0) > 0]
    if missing:
        raise AssertionError(f"{label}: no MB counted in {missing}")


# ---------------------------------------------------------------------------
# Phase 3b: containers, audio, copy and scaling
# ---------------------------------------------------------------------------

AUDIO_RATE = 48000
AUDIO_BITRATE = 128000
AUDIO_SNR_FLOOR_DB = 20.0    # decoded AAC vs its source, per codec pass
AAC_DELAY = 1024             # samples of delay each AAC encode adds
SCALE_SRC = (2160, 3840)     # the scaled path's source frames
SCALE_OUT = (1080, 1920)     # what -vf scale=1920:-2 makes of them
SCALE_FRAMES = 12
RESIZE_SHAPES = ((2160, 3840, 1080, 1920), (1080, 1920, 720, 1280))
MKV_TICK_NS = 11111          # Matroska timestamp scale: ~1 / 90 kHz
MKV_FRAME_TICKS = 3000       # 1 / 30 s


def two_tone(n: int, seed: int = 0) -> np.ndarray:
    """(n, 2) int16 at 48 kHz: 440 Hz left, 1 kHz right, seeded noise."""
    t = np.arange(n) / AUDIO_RATE
    rng = np.random.default_rng(seed)
    x = np.stack([9000 * np.sin(2 * np.pi * 440 * t),
                  7000 * np.sin(2 * np.pi * 1000 * t + 0.3)], 1)
    x = x + rng.normal(0, 200, (n, 2))
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def _ebml(eid: int, payload: bytes) -> bytes:
    """One EBML element with an 8-byte size."""
    import struct
    return (eid.to_bytes((eid.bit_length() + 7) // 8, "big")
            + struct.pack(">Q", len(payload) | (1 << 56)) + payload)


def _ebml_uint(eid: int, v: int) -> bytes:
    return _ebml(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def write_mkv(path: str, video, audio) -> None:
    """Matroska, 1 / 90 kHz ticks: ``video`` (avcC, width, height,
    [(length-prefixed sample, keyframe)]) at 30 fps and ``audio``
    (AudioSpecificConfig, [AU]) at 1024 samples a frame, as unlaced
    SimpleBlocks in timestamp order, a cluster every 8 frames."""
    import struct
    from vcp_tpu_torch.codec import mkv
    avcc, w, h, samples = video
    asc, aus = audio
    tracks = _ebml(mkv.TRACKS, _ebml(mkv.TRACK_ENTRY, (
        _ebml_uint(mkv.TRACK_NUMBER, 1) + _ebml_uint(mkv.TRACK_TYPE, 1)
        + _ebml(mkv.CODEC_ID, b"V_MPEG4/ISO/AVC")
        + _ebml(mkv.CODEC_PRIVATE, avcc)
        + _ebml(mkv.VIDEO, _ebml_uint(mkv.PIXEL_WIDTH, w)
                + _ebml_uint(mkv.PIXEL_HEIGHT, h))))
        + _ebml(mkv.TRACK_ENTRY, (
            _ebml_uint(mkv.TRACK_NUMBER, 2) + _ebml_uint(mkv.TRACK_TYPE, 2)
            + _ebml(mkv.CODEC_ID, b"A_AAC") + _ebml(mkv.CODEC_PRIVATE, asc)
            + _ebml(mkv.AUDIO, _ebml(mkv.SAMPLING_FREQUENCY,
                                     struct.pack(">d", AUDIO_RATE))
                    + _ebml_uint(mkv.CHANNELS, 2)))))
    ticks_per_au = 1024 / AUDIO_RATE * 1e9 / MKV_TICK_NS
    blocks = sorted(
        [(i * MKV_FRAME_TICKS, 1, d, key) for i, (d, key) in
         enumerate(samples)]
        + [(int(k * ticks_per_au), 2, d, True) for k, d in enumerate(aus)],
        key=lambda b: b[0])
    span = 8 * MKV_FRAME_TICKS
    clusters = {}
    for ts, track, data, key in blocks:
        base = ts // span * span
        clusters[base] = clusters.get(base, b"") + _ebml(
            mkv.SIMPLE_BLOCK, bytes([0x80 | track])
            + struct.pack(">hB", ts - base, 0x80 if key else 0) + data)
    body = b"".join(_ebml(mkv.CLUSTER, _ebml_uint(mkv.CLUSTER_TIMESTAMP, b)
                          + c) for b, c in sorted(clusters.items()))
    info = _ebml(mkv.INFO, _ebml_uint(mkv.TIMESTAMP_SCALE, MKV_TICK_NS))
    with open(path, "wb") as fh:
        fh.write(_ebml(mkv.EBML_HEADER, b"")
                 + _ebml(mkv.SEGMENT, info + tracks + body))


def write_avi(path: str, chunks: list, w: int, h: int, pcm) -> None:
    """AVI: ``00dc`` chunks of Annex-B access units (fourcc H264, 30 fps)
    and ``01wb`` chunks of s16 stereo PCM, with ``idx1``."""
    import struct

    def chunk(ckid, payload):
        return (ckid + struct.pack("<I", len(payload)) + payload
                + b"\x00" * (len(payload) & 1))

    def strh(kind, handler, scale, rate, length):
        return chunk(b"strh", kind + handler + struct.pack(
            "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, scale, rate, 0, length, 0,
            0xFFFFFFFF, 0, 0, 0, w, h))

    hdrl = [chunk(b"avih", struct.pack("<14I", 33333, 0, 0, 0x10,
                                       len(chunks), 0, 2, 0, w, h, 0, 0, 0,
                                       0)),
            chunk(b"LIST", b"strl" + strh(b"vids", b"H264", 1, 30,
                                          len(chunks))
                  + chunk(b"strf", struct.pack(
                      "<IiiHH4sIiiII", 40, w, h, 1, 24, b"H264", w * h * 3,
                      0, 0, 0, 0))),
            chunk(b"LIST", b"strl" + strh(b"auds", b"\x00" * 4, 1,
                                          AUDIO_RATE, len(pcm))
                  + chunk(b"strf", struct.pack(
                      "<HHIIHH", 1, 2, AUDIO_RATE, AUDIO_RATE * 4, 4, 16)))]
    per = -(-len(pcm) // len(chunks))
    movi = []
    for i, c in enumerate(chunks):
        movi.append(chunk(b"00dc", c))
        movi.append(chunk(b"01wb", pcm[i * per:(i + 1) * per]
                          .astype("<i2").tobytes()))
    idx = chunk(b"idx1", b"".join(struct.pack("<4sIII", m[:4], 0x10, 0, 0)
                                  for m in movi))
    body = (b"AVI " + chunk(b"LIST", b"hdrl" + b"".join(hdrl))
            + chunk(b"LIST", b"movi" + b"".join(movi)) + idx)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def make_av_inputs(tmp: str, video_mp4: str) -> dict:
    """The video of ``video_mp4`` (the h264-nvenc path's MP4) beside 48 kHz
    stereo audio of the same length, as MP4 + AAC-LC (the port's encoder,
    128 kb/s), Matroska + the same AAC frames (unlaced SimpleBlocks in
    decode order) and AVI + the s16 PCM. Returns the paths, the PCM and
    the AUs."""
    import struct
    from vcp_tpu_torch.codec import mp4
    from vcp_tpu_torch.codec.aac import AacEncoder
    d = mp4.Mp4Demuxer(video_mp4)
    v = d.video
    samples = [(d.sample(v, i), i in v.sync_samples)
               for i in range(v.sample_count)]
    pcm = two_tone(v.sample_count * AUDIO_RATE // 30)
    t0 = time.monotonic()
    enc = AacEncoder(rate=AUDIO_RATE, channels=2, bitrate=AUDIO_BITRATE)
    aus = enc.encode(pcm)
    log(f"  inputs: {len(aus)} AAC frames of {len(pcm)} samples encoded in "
        f"{time.monotonic() - t0:.3f} s")
    asc = enc.audio_specific_config()
    out = {k: os.path.join(tmp, f"{k}-in.{k.split('-')[0]}")
           for k in ("mp4-aac", "mkv-aac", "avi-pcm")}
    w = mp4.Mp4Writer()
    vt = mp4.VideoTrack(codec="h264", width=v.width, height=v.height,
                        timescale=v.timescale, sps=v.sps, pps=v.pps)
    vt.samples = [mp4.Sample(data=s, duration=dur, is_sync=key)
                  for (s, key), dur in zip(samples, v.sample_durations)]
    at = mp4.AudioTrack(codec="aac", sample_rate=AUDIO_RATE, channels=2,
                        timescale=AUDIO_RATE, decoder_config=asc,
                        avg_bitrate=AUDIO_BITRATE)
    at.samples = [mp4.Sample(data=a, duration=1024) for a in aus]
    w.add_track(vt)
    w.add_track(at)
    w.write(out["mp4-aac"])
    sps, pps = v.sps[0], v.pps[0]
    avcc = (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
            + struct.pack(">H", len(sps)) + sps
            + bytes([1]) + struct.pack(">H", len(pps)) + pps)
    write_mkv(out["mkv-aac"], (avcc, v.width, v.height, samples),
              (asc, aus))
    annexb = [b"".join(b"\x00\x00\x00\x01" + n
                       for n in d.sample_nals(v, i))
              for i in range(v.sample_count)]
    annexb[0] = b"".join(b"\x00\x00\x00\x01" + n for n in (sps, pps)) \
        + annexb[0]
    write_avi(out["avi-pcm"], annexb, v.width, v.height, pcm)
    return {"paths": out, "pcm": pcm, "aus": aus, "asc": asc,
            "video": [s for s, _ in samples]}


def video_samples(path: str) -> list:
    from vcp_tpu_torch.codec import mp4
    d = mp4.Mp4Demuxer(path)
    return [d.sample(d.video, i) for i in range(d.video.sample_count)]


def check_audio(label: str, path: str, av: dict, passes: int,
                same_aus: bool) -> None:
    """The MP4's AAC track: there, 48 kHz stereo with the source's
    AudioSpecificConfig and as many frames; re-encoded, not passed
    through (``same_aus``: equal to the source's AUs, which a PCM source
    encoded at the same bitrate gives); decoded by the port's AAC decoder
    to the clip's length and within AUDIO_SNR_FLOOR_DB of the source
    PCM after ``passes`` codec delays. A swallowed audio failure (no
    track, or the source passed through) fails here."""
    from vcp_tpu_torch.codec import mp4
    from vcp_tpu_torch.codec.aac_decode import AacDecoder
    d = mp4.Mp4Demuxer(path)
    a = d.audio
    if a is None or a.codec != "mp4a":
        raise AssertionError(f"{label}: no AAC track in the output")
    aus = [d.sample(a, i) for i in range(a.sample_count)]
    if (a.sample_rate, a.channels, a.decoder_config) != (
            AUDIO_RATE, 2, av["asc"]) or len(aus) != len(av["aus"]):
        raise AssertionError(f"{label}: audio track {a.sample_rate} Hz, "
                             f"{a.channels} ch, {len(aus)} frames")
    if (aus == av["aus"]) != same_aus:
        raise AssertionError(f"{label}: the AAC frames were "
                             f"{'not ' if same_aus else ''}re-encoded")
    t0 = time.monotonic()
    dec = AacDecoder(AUDIO_RATE, 2)
    pcm = np.concatenate([dec.decode_frame(x) for x in aus])
    dt = time.monotonic() - t0
    src = av["pcm"].astype(np.float64)
    lag = passes * AAC_DELAY
    n = min(len(src), len(pcm) - lag)
    err = pcm[lag:lag + n] - src[:n]
    snr = 10 * np.log10((src[:n] ** 2).sum() / max((err ** 2).sum(), 1e-9))
    log(f"  {label} audio: {len(aus)} AAC frames, decoded to {len(pcm)} "
        f"samples in {dt:.3f} s, SNR {snr:.2f} dB against the source after "
        f"{passes} codec pass(es) (floor {AUDIO_SNR_FLOOR_DB})")
    if not (np.isfinite(pcm).all() and len(pcm) >= len(src)
            and snr >= AUDIO_SNR_FLOOR_DB):
        raise AssertionError(f"{label}: decoded audio {len(pcm)} samples, "
                             f"SNR {snr:.2f} dB")


def run_host_path(label: str, src: str, tmp: str, cli_args: list[str],
                  content_s: float) -> tuple[str, dict]:
    """A CLI call that runs no video encode (copy, audio only), with the
    launch counts set to 0 just before and read just after."""
    from vcp_tpu_torch import cli
    dst = os.path.join(tmp, f"{label}.mp4")
    counters = launch_counters()
    seen: dict = {}
    with observe_encoder(seen):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.monotonic()
        rc = cli.main(["encode", src, dst, *cli_args, "--device", DEVICE])
        wall = time.monotonic() - t0
        launches = {k: getattr(fn, attr)
                    for k, (fn, attr) in counters.items()}
    if rc != 0:
        raise RuntimeError(f"{label}: cli encode exited {rc}")
    audio_s = sum(seen.get("audio_track_for", []))
    log(f"  {label}: {wall:.3f} s, audio_track_for {audio_s:.3f} s "
        f"({audio_s / content_s:.3f} s per second of content), launches "
        f"{launches}")
    return dst, launches


def check_resize(dev) -> None:
    """``bilinear_resize`` on the card against the CPU, every plane of
    4:2:0 frames at the shipped scalings: exact equality; its ms."""
    from vcp_tpu_torch.ops.scale import bilinear_resize
    rng = np.random.default_rng(11)
    for h, w, oh, ow in RESIZE_SHAPES:
        for name, (ph, pw, qh, qw) in (("y", (h, w, oh, ow)),
                                       ("u", (h // 2, w // 2, oh // 2,
                                              ow // 2)),
                                       ("v", (h // 2, w // 2, oh // 2,
                                              ow // 2))):
            x = torch.from_numpy(rng.integers(0, 256, (ph, pw),
                                              dtype=np.uint8))
            xd = x.to(dev)
            err = max_abs_err((bilinear_resize(xd, qh, qw).cpu(),),
                              (bilinear_resize(x, qh, qw),))
            ms = time_ms(lambda: bilinear_resize(xd, qh, qw), dev, 20)
            log(f"  bilinear_resize {name} {ph}x{pw} -> {qh}x{qw}: "
                f"max_abs_err {err}, {ms:.4f} ms on the card")
            if err != 0:
                raise AssertionError("bilinear_resize: cuda != cpu")


def run_containers(tmp: str, frames, by_path: dict) -> dict:
    """Phase 3b: ``-p h264-nvenc`` from an MP4 with AAC, an MKV with AAC
    and an AVI with PCM (the same video: the same NAL units out, each
    audio track there and re-encoded); ``-p copy`` of the MP4 (the same
    bytes) and of the MKV (its blocks and AAC frames in an MP4); ``-vn
    -c:a aac -b:a 128k``; and ``-vf scale=1920:-2`` of 2160p frames."""
    import filecmp
    from vcp_tpu_torch.codec import mp4
    from vcp_tpu_torch.codec.y4m import write_y4m
    from vcp_tpu_torch.ops.scale import scale_yuv420
    av = make_av_inputs(tmp, os.path.join(tmp, "h264-nvenc.mp4"))
    content_s = len(frames) / 30
    kernels = ("motion_search", "deblock_fast", "deblock_general")
    nals = {}
    for label in ("mp4-aac", "mkv-aac", "avi-pcm"):
        by_path[label], seen = run_main_path(
            label, frames, tmp, ["-p", "h264-nvenc"], [0, SCENE_CUT],
            kernels, src=av["paths"][label])
        audio_s = sum(seen.get("audio_track_for", []))
        log(f"  {label}: audio_track_for {audio_s:.3f} s "
            f"({audio_s / content_s:.3f} s per second of content)")
        out = os.path.join(tmp, f"{label}.mp4")
        check_audio(label, out, av, passes=1 if label == "avi-pcm" else 2,
                    same_aus=label == "avi-pcm")
        check_decoder(out, frames)
        nals[label] = video_samples(out)
    if not nals["mp4-aac"] == nals["mkv-aac"] == nals["avi-pcm"]:
        raise AssertionError("the three containers gave different video "
                             "NAL units")
    log(f"  video NAL units of mp4-aac == mkv-aac == avi-pcm: True "
        f"({len(nals['mp4-aac'])} samples)")

    dst, by_path["copy"] = run_host_path(
        "copy", av["paths"]["mp4-aac"], tmp, ["-p", "copy"], content_s)
    if not filecmp.cmp(dst, av["paths"]["mp4-aac"], shallow=False):
        raise AssertionError("copy of an MP4 is not byte-identical")
    check_mp4(dst, len(frames), [0, SCENE_CUT])
    log("  copy: byte-identical to its input (filecmp)")
    dst, by_path["copy-mkv"] = run_host_path(
        "copy-mkv", av["paths"]["mkv-aac"], tmp, ["-p", "copy"], content_s)
    d = mp4.Mp4Demuxer(dst)
    if video_samples(dst) != av["video"] or [
            d.sample(d.audio, i) for i in range(d.audio.sample_count)] \
            != av["aus"]:
        raise AssertionError("copy of an MKV: samples differ from its "
                             "blocks")
    check_mp4(dst, len(frames), [0, SCENE_CUT])
    check_decoder(dst, frames)
    log("  copy-mkv: video samples == the MKV blocks, audio samples == "
        "the AAC frames")

    dst, by_path["audio-only"] = run_host_path(
        "audio-only", av["paths"]["mp4-aac"], tmp,
        ["--ffmpeg-args=-vn -c:a aac -b:a 128k"], content_s)
    handlers = [t.handler for t in mp4.Mp4Demuxer(dst).tracks]
    if handlers != ["soun"]:
        raise AssertionError(f"audio-only: tracks {handlers}")
    check_audio("audio-only", dst, av, passes=2, same_aus=False)

    h, w = SCALE_SRC
    big = synth_frames(h, w, SCALE_FRAMES, SCALE_FRAMES)
    src = os.path.join(tmp, "scale-2160p.y4m")
    write_y4m(src, big, 30, 1)
    oh, ow = SCALE_OUT
    by_path["scale-2160p"], _ = run_main_path(
        "scale-2160p", big, tmp, ["--ffmpeg-args=-c:v h264_nvenc -preset p4 "
                                  f"-b:v 10M -vf scale={ow}:-2"], [0],
        kernels, src=src, faststart=False)
    dst = os.path.join(tmp, "scale-2160p.mp4")
    v = mp4.Mp4Demuxer(dst).video
    log(f"  scale-2160p: {v.width}x{v.height} from {w}x{h}")
    if (v.height, v.width) != SCALE_OUT:
        raise AssertionError(f"scaled output {v.width}x{v.height}")
    check_decoder(dst, [scale_yuv420(*f, oh, ow, DEVICE) for f in big])
    return av


# ---------------------------------------------------------------------------
# Phase 3c: HEVC
# ---------------------------------------------------------------------------

HEVC_FRAMES = 8              # 1080p frames of h265-nvenc and h265-cpu
HEVC_CUT = 5                 # their scene cut: IDRs at 0 and 5
HEVC_GOP = 30                # the HEVC encoder's GOP at 30 fps
HEVC_INGEST_FRAMES = 4
HEVC_INGEST_ARGS = ("-c:v hevc_nvenc -preset p4 -b:v 8M -g 1 "
                    "-movflags +faststart")      # intra only: ingestable


def hevc_idrs(n: int, cuts: tuple[int, ...], gop: int = HEVC_GOP):
    """IDR frames of the HEVC encoder: every ``gop``-th frame it has coded
    (a cut does not restart that count) and every scene cut."""
    return sorted({i for i in range(n) if i % gop == 0}
                  | {c for c in cuts if c < n})


def check_hevc_decoder(path: str, source) -> None:
    """The port's HEVC validation decoder on an MP4 the port wrote: every
    frame close to the source."""
    from vcp_tpu_torch.codec.h264.decoder import psnr
    from vcp_tpu_torch.codec.h265.decoder import decode_mp4
    t0 = time.monotonic()
    frames = list(decode_mp4(path))
    dt = time.monotonic() - t0
    if len(frames) != len(source):
        raise AssertionError(f"decoded {len(frames)} frames of "
                             f"{len(source)}")
    db = [psnr(f[0], s[0]) for f, s in zip(frames, source)]
    log(f"  HEVC decode of {os.path.basename(path)}: {len(frames)} frames "
        f"{frames[0][0].shape} in {dt:.3f} s, luma PSNR vs the source min "
        f"{min(db):.2f} dB, mean {statistics.mean(db):.2f} dB (floor "
        f"{DECODE_PSNR_FLOOR_DB})")
    if not min(db) >= DECODE_PSNR_FLOOR_DB:
        raise AssertionError(f"HEVC decode {min(db):.2f} dB below the "
                             "floor")


def check_hevc_tools(label: str, seen: dict, rd_intra: bool) -> None:
    """The HEVC path coded quarter-phase vectors in its P slices and, on
    the RD intra paths, left-dependent luma modes in its IDRs; logs the
    host seconds of the CABAC slice writer."""
    cabac = seen.get("hevc_cabac_s", [])
    share = seen.get("quarter_pel_mvs", 0) / max(1, seen.get("mvs", 0))
    log(f"  {label}: syntax.encode_slice_data {sum(cabac):.3f} s over "
        f"{len(cabac)} slices ({sum(cabac) / max(1, len(cabac)):.3f} s per "
        f"frame, max {max(cabac, default=0):.3f}); vectors with a quarter "
        f"phase {seen.get('quarter_pel_mvs', 0)} of {seen.get('mvs', 0)} "
        f"(share {share:.4f}); IDR CTUs with a left-dependent mode "
        f"{seen.get('left_mode_ctus', 0)} of {seen.get('idr_ctus', 0)}")
    if seen.get("mvs", 0) and not share > 0:
        raise AssertionError(f"{label}: no vector has a quarter phase")
    if rd_intra and not seen.get("left_mode_ctus", 0) > 0:
        raise AssertionError(f"{label}: no IDR CTU chose planar or an "
                             "angular mode below 26")


_POOL: list = []      # (executor, directory of the MP4s it decodes)


def submit_hevc_decode(decodes: list, path: str, source) -> None:
    """Run ``check_hevc_decoder`` on a copy of ``path`` in one of two child
    processes (spawned, so they share no CUDA state with this process;
    they use no card), beside the later phases."""
    import shutil
    if not _POOL:
        import concurrent.futures
        import multiprocessing
        _POOL.append((concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")),
            tempfile.mkdtemp(prefix="hevc_decode_")))
    pool, keep = _POOL[0]
    copy = os.path.join(keep, os.path.basename(path))
    shutil.copyfile(path, copy)
    decodes.append(pool.submit(check_hevc_decoder, copy, source))


def finish_decodes(decodes: list) -> None:
    """Wait for the HEVC validation decodes (a failed one raises here),
    stop their processes and remove their copies."""
    import shutil
    t0 = time.monotonic()
    try:
        for f in decodes:
            f.result()
    finally:
        while _POOL:
            pool, keep = _POOL.pop()
            pool.shutdown(cancel_futures=True)
            shutil.rmtree(keep, ignore_errors=True)
    log(f"  HEVC validation decodes: {len(decodes)} done, waited "
        f"{time.monotonic() - t0:.1f} s for them")


def no_launches(label: str, launches: dict) -> None:
    if any(launches.values()):
        raise AssertionError(f"{label}: the HEVC path launched H.264 "
                             f"kernels {launches}")


def run_hevc(tmp: str, hframes, hq_src: str, hq_frames, av: dict,
             by_path: dict, decodes: list) -> None:
    """Phase 3c: ``-p h265-nvenc`` and ``-p h265-cpu`` from a Y4M (a scene
    cut: 2 IDRs, 6 P frames), ``-p h265-nvenc-hq`` from ``hq_src`` (an
    MP4 with AAC, its audio re-encoded at 192 kb/s) and HEVC ingest (an
    intra-only HEVC MP4 of the port's, decoded on the host and encoded
    with ``-p h264-nvenc``). Every HEVC encode launches none of the four
    kernels. Each HEVC output's validation decode (pure Python, ~2.5 s a
    1080p frame) runs in a child process beside the later phases; the
    caller waits for the futures in ``decodes`` before it reports."""
    def decode(path, source):
        submit_hevc_decode(decodes, path, source)

    for label, rd in (("h265-nvenc", False), ("h265-cpu", True)):
        by_path[label], seen = run_main_path(
            label, hframes, tmp, ["-p", label],
            hevc_idrs(len(hframes), (HEVC_CUT,)), (), entry=b"hvc1")
        no_launches(label, by_path[label])
        check_hevc_tools(label, seen, rd)
        decode(os.path.join(tmp, f"{label}.mp4"), hframes)
    label = "h265-nvenc-hq"
    by_path[label], seen = run_main_path(
        label, hq_frames, tmp, ["-p", label],
        hevc_idrs(len(hq_frames), (SCENE_CUT,)), (), src=hq_src,
        entry=b"hvc1")
    no_launches(label, by_path[label])
    check_hevc_tools(label, seen, True)
    out = os.path.join(tmp, f"{label}.mp4")
    check_audio(label, out, av, passes=2, same_aus=False)
    decode(out, hq_frames)

    ing = hframes[:HEVC_INGEST_FRAMES]
    by_path["hevc-ingest-src"], _ = run_main_path(
        "hevc-ingest-src", ing, tmp, [f"--ffmpeg-args={HEVC_INGEST_ARGS}"],
        list(range(len(ing))), (), entry=b"hvc1")
    no_launches("hevc-ingest-src", by_path["hevc-ingest-src"])
    src = os.path.join(tmp, "hevc-ingest-src.mp4")
    decode(src, ing)
    by_path["hevc-ingest"], _ = run_main_path(
        "hevc-ingest", ing, tmp, ["-p", "h264-nvenc"], [0],
        ("motion_search", "deblock_fast", "deblock_general"), src=src)
    check_decoder(os.path.join(tmp, "hevc-ingest.mp4"), ing)


# ---------------------------------------------------------------------------
# Phase 3d: the control plane
# ---------------------------------------------------------------------------

CONTROL_WAIT_S = 300         # until 3 tasks succeed and 1 fails
CONTROL_FILE_WAIT_S = 3      # consumer.file_wait_timeout of the phase
CONTROL_DRAIN_S = 5.0        # consumer.stop()'s drain
ROOT = os.path.dirname(os.path.abspath(__file__))


def _cli_proc(args: list[str], log_path: str) -> subprocess.Popen:
    """``python -m vcp_tpu_torch.cli ARGS`` from the checkout, its output
    to ``log_path``."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with open(log_path, "w") as fh:
        return subprocess.Popen([sys.executable, "-m", "vcp_tpu_torch.cli",
                                 *args], cwd=ROOT, env=env, stdout=fh,
                                stderr=subprocess.STDOUT)


def _wait_for(what: str, pred, timeout: float, procs=()) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        for p, log_path in procs:
            if p.poll() is not None:
                raise RuntimeError(f"{what}: process exited {p.returncode}:"
                                   f"\n{open(log_path).read()[-4000:]}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not within {timeout:.0f} s")
        time.sleep(0.1)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_vp9_webm(path: str) -> None:
    """A WebM whose one video track is VP9: the producer must refuse it."""
    from vcp_tpu_torch.codec import mkv
    entry = (_ebml_uint(mkv.TRACK_NUMBER, 1) + _ebml_uint(mkv.TRACK_TYPE, 1)
             + _ebml(mkv.CODEC_ID, b"V_VP9")
             + _ebml(mkv.VIDEO, _ebml_uint(mkv.PIXEL_WIDTH, W)
                     + _ebml_uint(mkv.PIXEL_HEIGHT, H)))
    info = _ebml(mkv.INFO, _ebml_uint(mkv.TIMESTAMP_SCALE, 1_000_000))
    with open(path, "wb") as fh:
        fh.write(_ebml(mkv.EBML_HEADER, b"") + _ebml(mkv.SEGMENT, info + _ebml(
            mkv.TRACKS, _ebml(mkv.TRACK_ENTRY, entry))))


class _Tee:
    """The port's log sink for the phase: stderr, and the lines kept."""

    def __init__(self):
        self.lines: list[str] = []

    def write(self, s: str) -> None:
        self.lines.append(s)
        sys.stderr.write(s)

    def flush(self) -> None:
        sys.stderr.flush()


def run_control_plane(tmp: str, av: dict, by_path: dict) -> None:
    """Phase 3d: the farm on one card. The port's ``redis-serve``, two
    ``producer`` processes (watch dir A with ``-p h264-nvenc``, watch dir
    B with ``-p copy``; one shared and one output dir) and a ``Consumer``
    in this process (``concurrency=2``, ``device="cuda"``, as ``cli
    consumer`` runs it), with the launch counts set to 0 just before it
    starts and read once its tasks are done. Into A go phase 3's 40-frame
    1080p Y4M, phase 3b's MP4 + AAC and a VP9 WebM (refused at publish);
    into B the same MP4; one task with no input is published directly.
    The transcodes must equal phase 3 / 3b's direct encodes NAL unit for
    NAL unit, the copy its source byte for byte; the queue, the shared
    dir and, after ``clean --all``, the stream and the history are
    empty."""
    import filecmp
    import io
    import shutil
    import signal
    from vcp_tpu_torch import cli
    from vcp_tpu_torch import logging as vlog
    from vcp_tpu_torch.codec import mp4
    from vcp_tpu_torch.config import BUILTIN_PRESETS, load_config
    from vcp_tpu_torch.pipeline.consumer import Consumer
    from vcp_tpu_torch.queue.history import HistoryManager
    from vcp_tpu_torch.queue.stream import Stream, Task
    t_phase = time.monotonic()
    root = os.path.join(tmp, "farm")
    dirs = {k: os.path.join(root, k) for k in ("a", "b", "shared", "out",
                                               "stage", "logs")}
    for d in dirs.values():
        os.makedirs(d)
    addr = f"127.0.0.1:{_free_port()}"
    cfg_path = os.path.join(root, "farm.yaml")
    with open(cfg_path, "w") as fh:
        fh.write(f'redis:\n  address: "{addr}"\n'
                 "producer:\n  verify_output: true\n"
                 "consumer:\n  name: chip\n  concurrency: 2\n"
                 f"  file_wait_timeout: {CONTROL_FILE_WAIT_S}\n"
                 "  verify_output: true\n")
    procs: list = []
    tee = _Tee()
    consumer = None
    try:
        log_path = os.path.join(dirs["logs"], "redis.log")
        procs.append((_cli_proc(["redis-serve", "--port",
                                 addr.rsplit(":", 1)[1]], log_path),
                      log_path))
        probe = Stream(addr)
        _wait_for("redis-serve", probe.ping, 60, procs)
        for name, watch, preset in (("producer-a", dirs["a"], "h264-nvenc"),
                                    ("producer-b", dirs["b"], "copy")):
            log_path = os.path.join(dirs["logs"], f"{name}.log")
            procs.append((_cli_proc(
                ["producer", "-c", cfg_path, "-w", watch, "-s",
                 dirs["shared"], "-o", dirs["out"], "-p", preset],
                log_path), log_path))
        _wait_for("producers", lambda: all(
            "producer starting" in open(lp).read()
            for _, lp in procs[1:]), 60, procs)

        cfg = load_config(cfg_path)
        counters = launch_counters()
        vlog.set_sink(tee)
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        consumer = Consumer(cfg, name="chip", concurrency=2, device=DEVICE)
        consumer.start()

        def drop(name, watch, src):
            staged = os.path.join(dirs["stage"], name)
            if src is None:
                write_vp9_webm(staged)
            else:
                shutil.copyfile(src, staged)
            os.rename(staged, os.path.join(watch, name))

        # the two transcodes first, so that they take the two workers
        # together; then the copy and the WebM; the task with no input
        # last, so that its file wait holds no worker a transcode needs
        drop("nvenc.y4m", dirs["a"], os.path.join(tmp, "h264-nvenc.y4m"))
        drop("aac.mp4", dirs["a"], av["paths"]["mp4-aac"])
        _wait_for("both transcodes taken",
                  lambda: consumer.counters.processed >= 2, 60, procs)
        drop("aac-copy.mp4", dirs["b"], av["paths"]["mp4-aac"])
        drop("vp9.webm", dirs["a"], None)
        _wait_for("the copy taken",
                  lambda: consumer.counters.processed >= 3, CONTROL_WAIT_S,
                  procs)
        probe.publish(Task(
            id="no-input", input_path=os.path.join(dirs["shared"],
                                                   "missing.y4m"),
            original_name="missing.y4m", output_dir=dirs["out"],
            output_name="missing.mp4",
            ffmpeg_args=BUILTIN_PRESETS["h264-nvenc"], verify_output=True))
        _wait_for("3 succeeded, 1 failed", lambda: (
            consumer.counters.succeeded + consumer.counters.failed >= 4),
            CONTROL_WAIT_S, procs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: getattr(fn, attr) for k, (fn, attr) in
                    counters.items()}
        by_path["stream"] = launches
        snap = consumer.counters.snapshot()
        t_stop = time.monotonic()
        consumer.stop(drain_timeout=CONTROL_DRAIN_S)
        stop_s = time.monotonic() - t_stop
        alive = [t.name for t in consumer._threads if t.is_alive()]
        consumer = None
        vlog.set_sink(sys.stderr)
        log(f"  stream: 4 tasks in {wall:.3f} s, counters {snap}, launches "
            f"{launches}; consumer.stop() {stop_s:.3f} s (drain "
            f"{CONTROL_DRAIN_S} s)")
        if snap != {"processed": 4, "succeeded": 3, "failed": 1}:
            raise AssertionError(f"stream: consumer counters {snap}")
        if alive or stop_s > CONTROL_DRAIN_S + 1.0:
            raise AssertionError(f"stream: stop() {stop_s:.3f} s, threads "
                                 f"alive {alive}")
        missing = [k for k in ("motion_search", "deblock_fast",
                               "deblock_general") if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched from the consumer: "
                                 f"{missing}")

        out = {k: os.path.join(dirs["out"], f"{k}.mp4")
               for k in ("nvenc", "aac", "aac-copy")}
        for label, direct in (("nvenc", "h264-nvenc.mp4"),
                              ("aac", "mp4-aac.mp4")):
            if video_samples(out[label]) != video_samples(
                    os.path.join(tmp, direct)):
                raise AssertionError(f"stream: {label}.mp4's video NAL "
                                     f"units differ from {direct}'s")
        check_audio("stream-aac", out["aac"], av, passes=2, same_aus=False)
        d, ref = mp4.Mp4Demuxer(out["aac"]), mp4.Mp4Demuxer(
            os.path.join(tmp, "mp4-aac.mp4"))
        if [d.sample(d.audio, i) for i in range(d.audio.sample_count)] != [
                ref.sample(ref.audio, i)
                for i in range(ref.audio.sample_count)]:
            raise AssertionError("stream: aac.mp4's AAC frames differ from "
                                 "mp4-aac.mp4's")
        if not filecmp.cmp(out["aac-copy"], av["paths"]["mp4-aac"],
                           shallow=False):
            raise AssertionError("stream: the copy differs from its source")
        for path in out.values():
            ok, reason = mp4.verify_video_file(path)
            if not ok:
                raise AssertionError(f"stream: verify {path}: {reason}")
        log("  stream: nvenc / aac video NAL units == the direct encodes', "
            "aac's AAC frames == mp4-aac's, aac-copy == its source "
            "(filecmp), verify_video_file passes on all three")
        leftover = {k: sorted(os.listdir(dirs[k])) for k in ("shared", "a",
                                                             "b")}
        if leftover != {"shared": [], "a": ["vp9.webm"], "b": []}:
            raise AssertionError(f"stream: files left {leftover}")
        info = probe.get_queue_info()
        if (info.length, info.pending) != (0, 0):
            raise AssertionError(f"stream: queue {info}")
        recs = HistoryManager(probe.client).get_all_history()
        status = sorted((r.original_name, r.status, r.consumer)
                        for r in recs)
        want = sorted([("nvenc.y4m", "completed", "chip"),
                       ("aac.mp4", "completed", "chip"),
                       ("aac-copy.mp4", "completed", "chip"),
                       ("missing.y4m", "failed", "chip")])
        if status != want:
            raise AssertionError(f"stream: history {status}")
        encode_s = {}
        for line in tee.lines:
            if "task success" in line:
                fields = dict(f.split("=", 1) for f in line.split()
                              if "=" in f)
                encode_s[fields["task"]] = float(fields["encode"][:-1])
        for r in sorted(recs, key=lambda r: r.start_time):
            log(f"  stream: {r.original_name}: {r.status}, dispatch "
                f"{r.dispatch_sec * 1000:.1f} ms, task {r.duration_sec:.3f} "
                f"s (file wait, encode, verify), encode "
                f"{encode_s.get(r.task_id, float('nan')):.3f} s"
                + (f", error {r.error!r}" if r.error else ""))
        by_name = {r.original_name: r for r in recs}
        spans = [(by_name[n].start_time, by_name[n].end_time)
                 for n in ("nvenc.y4m", "aac.mp4")]
        overlap = min(e for _, e in spans) - max(s for s, _ in spans)
        for name, serial in (("nvenc.y4m", "h264-nvenc"),
                             ("aac.mp4", "mp4-aac")):
            enc = encode_s[by_name[name].task_id]
            log(f"  stream: {name}: {N_FRAMES / enc:.2f} fps beside the "
                f"other transcode (overlap {overlap:.3f} s), serial "
                f"{N_FRAMES / WALL_S[serial]:.2f} fps ({serial}, "
                f"{WALL_S[serial]:.3f} s)")

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["stats", "-c", cfg_path])
        text = buf.getvalue()
        if rc != 0 or "completed : 3" not in text \
                or "failed    : 1" not in text \
                or "stream length : 0" not in text:
            raise AssertionError(f"stream: stats exited {rc}:\n{text}")
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["clean", "--all", "-f", "-c", cfg_path])
        keys = probe.client.execute("KEYS", "*")
        if rc != 0 or keys:
            raise AssertionError(f"stream: clean exited {rc}, keys left "
                                 f"{keys}")
        log("  stream: stats printed 3 completed / 1 failed; clean --all "
            "left no key")
        probe.close()
        for p, log_path in procs[1:]:
            p.send_signal(signal.SIGINT)
        for p, log_path in procs[1:]:
            rc = p.wait(timeout=30)
            if rc != 0:
                raise AssertionError(f"producer exited {rc} on SIGINT:\n"
                                     f"{open(log_path).read()[-4000:]}")
        logs = [open(lp).read() for _, lp in procs[1:]]
        published = [text.count("task start") for text in logs]
        refused = [text.count("rejected at publish") for text in logs]
        if (published, refused) != ([2, 1], [1, 0]) \
                or "V_VP9" not in logs[0]:
            raise AssertionError(f"stream: producers published {published}, "
                                 f"refused {refused}")
        log(f"  stream: producers published {published}, refused the VP9 "
            f"WebM at publish and exited 0 on SIGINT; phase wall "
            f"{time.monotonic() - t_phase:.3f} s")
    finally:
        vlog.set_sink(sys.stderr)
        if consumer is not None:
            consumer.stop(drain_timeout=CONTROL_DRAIN_S)
        for p, _ in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


# ---------------------------------------------------------------------------
# Phase 3e: CAVLC and the I16-only RD IDR
# ---------------------------------------------------------------------------

CAVLC_FRAMES = 9             # 1080p frames of cavlc-speed and rdi-nvenc
# the speed shape (effort 4) at constant QP: -crf, so that no rate
# controller reacts to the entropy coder's bit count
CAVLC_SPEED_ARGS = ("-c:v libx264 -preset fast -crf 23 -bf 0 "
                    "-movflags +faststart")
# CAVLC on the quality preset: the I16-only RD IDR; VCP_CABAC=0 also turns
# off the B pictures and partitions that -p h264-cpu adds with CABAC, so
# both are turned on again, which puts the Python CAVLC P and B writers
# on the path
CAVLC_CPU_ENV = {"VCP_CABAC": "0", "VCP_BFRAMES": "2", "VCP_PARTS": "1"}


def cavlc_mp4(path: str) -> bool:
    """The MP4's PPS has entropy_coding_mode_flag 0."""
    from vcp_tpu_torch.codec import mp4
    from vcp_tpu_torch.codec.h264.headers import parse_pps
    from vcp_tpu_torch.utils.bitstream import emulation_remove
    pps = mp4.Mp4Demuxer(path).video.pps[0]
    return not parse_pps(emulation_remove(pps[1:])).cabac


def log_writers(label: str, seen: dict, n_frames: int) -> None:
    """The host seconds of the entropy stage and of its Python CAVLC
    writers, and the RD IDR dispatch."""
    stage = sum(e.stage_s["entropy"] for e in seen["encoders"])
    py_p, py_b = (seen.get(k, []) for k in ("write_pslice", "write_bslice"))
    rd = seen.get("encode_iframe_rd", []) + seen.get("encode_iframe_rd8",
                                                     [])
    log(f"  {label}: entropy stage {stage:.3f} s for {n_frames} frames "
        f"({stage / n_frames:.4f} s per frame); Python CAVLC P writer "
        f"{sum(py_p):.3f} s over {len(py_p)} slices, B writer "
        f"{sum(py_b):.3f} s over {len(py_b)} slices; native writers and "
        f"unpacking {stage - sum(py_p) - sum(py_b):.3f} s; RD IDR "
        f"dispatch {[round(t, 3) for t in rd]} s")


def run_cavlc(tmp: str, frames, bq, by_path: dict) -> None:
    """Phase 3e: ``VCP_CABAC=0`` on the speed shape beside its CABAC twin
    (the same kernel launches, the same decoded pictures, equal to the
    encoder's recon), on ``-p h264-cpu`` with B pictures and partitions
    (the I16-only RD IDR, the Python CAVLC P and B writers), and
    ``VCP_RDI=1 -p h264-nvenc`` (the I16-only RD IDR under CABAC)."""
    kernels = ("motion_search", "deblock_fast", "deblock_general")
    cli_args = [f"--ffmpeg-args={CAVLC_SPEED_ARGS}"]
    speed = frames[:CAVLC_FRAMES]
    pictures, recon = {}, {}
    for label, env in (("cavlc-speed", {"VCP_CABAC": "0"}),
                       ("cavlc-speed-cabac", None)):
        by_path[label], seen = run_main_path(label, speed, tmp, cli_args,
                                             [0], kernels, env=env)
        log_writers(label, seen, len(speed))
        path = os.path.join(tmp, f"{label}.mp4")
        if cavlc_mp4(path) != (env is not None):
            raise AssertionError(f"{label}: PPS entropy_coding_mode_flag")
        pictures[label] = check_decoder(path, speed)
        recon[label] = seen["encoders"][0].recon_planes
        sizes = [len(x) for x in video_samples(path)]
        log(f"  {label}: IDR {sizes[0]} bytes, P pictures {sum(sizes[1:])} "
            f"bytes ({min(sizes[1:])}-{max(sizes[1:])} each)")
    a, b = by_path["cavlc-speed"], by_path["cavlc-speed-cabac"]
    if any(a[k] != b[k] for k in kernels):
        raise AssertionError(f"cavlc-speed launches {a} != CABAC's {b}")
    same = all(np.array_equal(x, y) for fa, fb in zip(
        pictures["cavlc-speed"], pictures["cavlc-speed-cabac"])
        for x, y in zip(fa, fb))
    last = all(np.array_equal(x, y) for x, y in zip(
        pictures["cavlc-speed"][-1], recon["cavlc-speed"]))
    log(f"  cavlc-speed: launches == CABAC twin's; {len(speed)} decoded "
        f"pictures identical to the twin's: {same}; last == the "
        f"encoder's recon: {last}")
    if not (same and last):
        raise AssertionError("cavlc-speed: decoded pictures differ")

    by_path["cavlc-cpu"], seen = run_main_path(
        "cavlc-cpu", bq, tmp, ["-p", "h264-cpu"], [0],
        ("deblock_fast", "deblock_general"), env=CAVLC_CPU_ENV,
        cts=gop_cts(len(bq), 2))
    log_writers("cavlc-cpu", seen, len(bq))
    path = os.path.join(tmp, "cavlc-cpu.mp4")
    keys = ("p_part_mbs", "b_mode0_mbs", "b_mode1_mbs", "b_mode2_mbs",
            "b_no_residual_mbs")
    log("  cavlc-cpu: " + ", ".join(f"{k} {seen.get(k, 0)}" for k in keys)
        + f", p_intra_mbs {seen.get('p_intra_mbs', 0)}")
    missing = [k for k in keys if not seen.get(k, 0) > 0]
    if missing or not cavlc_mp4(path) or not seen.get("write_bslice") \
            or not seen.get("encode_iframe_rd"):
        raise AssertionError(f"cavlc-cpu: no MB counted in {missing}, or "
                             "not CAVLC, or no Python B writer / "
                             "encode_iframe_rd call")
    check_decoder(path, bq)

    speed_rdi = frames[:CAVLC_FRAMES]
    by_path["rdi-nvenc"], seen = run_main_path(
        "rdi-nvenc", speed_rdi, tmp, ["-p", "h264-nvenc"], [0], kernels,
        env={"VCP_RDI": "1"})
    log_writers("rdi-nvenc", seen, len(speed_rdi))
    modes = seen.get("idr_modes", [])
    log(f"  rdi-nvenc: I16 modes of the IDR (V, H, DC, Plane) {modes}")
    if not seen.get("encode_iframe_rd") or len(modes) != 1 \
            or sum(m > 0 for m in modes[0]) < 2:
        raise AssertionError("rdi-nvenc: no per-MB I16 modes in the IDR")
    check_decoder(os.path.join(tmp, "rdi-nvenc.mp4"), speed_rdi)


def run_cavlc_only(frames, bq, t_start: float) -> int:
    """``--cavlc-only``: phase 3e and its phase-4 GOP alone, for a short
    run after a change to the CAVLC writers or the RD IDR; prints no
    result."""
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    by_path: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        log(f"phase 3e: CAVLC and the I16 RD IDR "
            f"({time.monotonic() - t_start:.1f} s)")
        run_cavlc(tmp, frames, bq, by_path)
    with scoped_env({**CAVLC_CPU_ENV, "VCP_HIER_ME": "0"}):
        check_devices("cavlc-cpu-exhaustive", bq[:4],
                      BUILTIN_PRESETS["h264-cpu"],
                      count=("motion_search_only",))
    log(f"CAVLC phases done at {time.monotonic() - t_start:.1f} s; "
        f"launches {by_path}")
    print("cavlc only: no result")
    return 0


# ---------------------------------------------------------------------------
# Phase 3f: the tile mesh
# ---------------------------------------------------------------------------

MESH_FRAMES = 9              # IDR + one chunk of 8 P pictures
# the medium preset under CAVLC: no B pictures, 8x8 transform or
# partitions, so the mesh takes it; sr 12 with half-pel, the search-only
# kernel in bands
MESH_Q_ARGS = "-c:v libx264 -preset medium -b:v 10M -movflags +faststart"
MESH_Q_ENV = {"VCP_CABAC": "0"}
MESH_BATCH = 4               # 1080p frames of the sharded intra batch


@contextlib.contextmanager
def mesh_on(n_tile: int | None):
    """While active, ``VCP_MESH=n_tile`` with ``n_tile`` copies of the
    ``DEVICE`` visible (the bands share card 0 or the CPU), or with
    ``n_tile`` None the devices as they are and no ``VCP_MESH``; yields
    the list of meshes ``H264Encoder._encode_gop_mesh`` is called with."""
    from vcp_tpu_torch.codec.h264.encoder import H264Encoder
    from vcp_tpu_torch.parallel import mesh as meshmod
    real_vis, real_gop = (meshmod.visible_devices,
                          H264Encoder._encode_gop_mesh)
    meshes: list = []

    def gop(self, frames, mesh):
        meshes.append(mesh)
        return real_gop(self, frames, mesh)
    if n_tile is not None:
        one = torch.device("cpu") if DEVICE == "cpu" \
            else torch.device("cuda", 0)
        meshmod.visible_devices = lambda device: [one] * n_tile
    H264Encoder._encode_gop_mesh = gop
    try:
        with scoped_env(None if n_tile is None
                        else {"VCP_MESH": str(n_tile)}):
            yield meshes
    finally:
        meshmod.visible_devices = real_vis
        H264Encoder._encode_gop_mesh = real_gop


def _mesh_path(label: str, frames, tmp: str, cli_args: list[str],
               n_tile: int | None, want: dict, ref_label: str,
               env: dict | None = None) -> tuple[dict, dict]:
    """One CLI encode over the mesh: it must go through
    ``_encode_gop_mesh`` on a (1, n_tile) mesh, launch exactly ``want``
    and give the video samples of the one-device path ``ref_label``."""
    with mesh_on(n_tile) as meshes:
        launches, seen = run_main_path(
            label, frames, tmp, cli_args, [0],
            tuple(k for k, v in want.items() if v), env=env)
    shapes = [m.shape for m in meshes]
    devices = sorted({str(d) for m in meshes for d in m.flat})
    same = video_samples(os.path.join(tmp, f"{label}.mp4")) == \
        video_samples(os.path.join(tmp, f"{ref_label}.mp4"))
    log(f"  {label}: meshes {shapes} on {devices}; launches == predicted "
        f"{want}: {launches == want}; video samples == {ref_label}'s: "
        f"{same}")
    if not meshes or any(sh["tile"] < 2 for sh in shapes) \
            or launches != want or not same:
        raise AssertionError(f"{label}: meshes {shapes}, launches "
                             f"{launches} (predicted {want}), samples equal "
                             f"to {ref_label}'s: {same}")
    return launches, seen


def run_mesh(tmp: str, frames, bq, by_path: dict) -> None:
    """Phase 3f: the tile mesh on card 0. The CLI encodes 9
    frames of ``-p h264-nvenc`` with ``VCP_MESH=t`` and t copies of
    ``cuda:0`` visible, t = 2 and 4: the P frames in t bands each (kernel
    1 with row0), the gathered planes deblocked by ``deblock_general``
    without the strong filter; the NAL units must equal the one-device
    encode's (at sr 8 a band's search is the whole frame's). Then 5 frames
    of the medium preset under CAVLC on 4 bands (sr 12, half-pel: kernel 2
    with row0), equal to the one-device encode with the exhaustive search
    (``VCP_HIER_ME=0``). The 4-band speed MP4 is decoded by the host
    decoder. With more than one card the speed path also runs over the
    cards themselves."""
    speed = frames[:MESH_FRAMES]
    n_p = len(speed) - 1
    one_dev = ("motion_search", "deblock_fast", "deblock_general")
    run_main_path("mesh-1dev", speed, tmp, ["-p", "h264-nvenc"], [0],
                  one_dev)
    for n_tile in MESH_TILES:
        by_path[f"mesh-t{n_tile}"], _ = _mesh_path(
            f"mesh-t{n_tile}", speed, tmp, ["-p", "h264-nvenc"], n_tile,
            {"motion_search": n_p * n_tile, "motion_search_only": 0,
             "deblock_fast": 0, "deblock_general": 1,
             "deblock_general_no_strong": n_p}, "mesh-1dev")
    # the one-device encode again, so that neither side has the warm-up
    run_main_path("mesh-1dev-after", speed, tmp, ["-p", "h264-nvenc"], [0],
                  one_dev)
    wall_1dev = (WALL_S["mesh-1dev"] + WALL_S["mesh-1dev-after"]) / 2
    log("  mesh fps against the one-device encode (the mean of its walls "
        "before and after): " + ", ".join(
            f"t={t} {wall_1dev / WALL_S[f'mesh-t{t}']:.3f}x"
            for t in MESH_TILES))
    check_decoder(os.path.join(tmp, f"mesh-t{MESH_TILES[-1]}.mp4"), speed)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        tiles = max(t for t in range(2, n_cards + 1) if (HP // 16) % t == 0)
        by_path["mesh-cards"], _ = _mesh_path(
            "mesh-cards", speed, tmp, ["-p", "h264-nvenc"], None,
            {"motion_search": n_p * tiles, "motion_search_only": 0,
             "deblock_fast": 0, "deblock_general": 1,
             "deblock_general_no_strong": n_p * tiles}, "mesh-1dev")
    else:
        log("  one card visible: the bands of every mesh shared cuda:0 "
            "(the branch over distinct cards needs two)")

    q_cli = [f"--ffmpeg-args={MESH_Q_ARGS}"]
    run_main_path("mesh-cavlc-1dev", bq, tmp, q_cli, [0],
                  ("motion_search_only",),
                  env={**MESH_Q_ENV, "VCP_HIER_ME": "0"})
    by_path["mesh-cavlc-t4"], seen = _mesh_path(
        "mesh-cavlc-t4", bq, tmp, q_cli, 4,
        {"motion_search": 0, "motion_search_only": 4 * (len(bq) - 1),
         "deblock_fast": 0, "deblock_general": 1,
         "deblock_general_no_strong": len(bq) - 1}, "mesh-cavlc-1dev",
        env=MESH_Q_ENV)
    path = os.path.join(tmp, "mesh-cavlc-t4.mp4")
    log(f"  mesh-cavlc-t4: MBs with a half-pel vector "
        f"{seen.get('half_pel_mvs', 0)}; CAVLC: {cavlc_mp4(path)}; "
        f"{WALL_S['mesh-cavlc-1dev'] / WALL_S['mesh-cavlc-t4']:.3f}x the "
        "one-device fps")
    if not seen.get("half_pel_mvs", 0) > 0 or not cavlc_mp4(path):
        raise AssertionError("mesh-cavlc-t4: no half-pel vector, or not "
                             "CAVLC")


def check_iframe_batch(frames) -> None:
    """``encode_iframe_batch_sharded`` on 1080p frames over 4 x cuda:0 and
    4 x cpu: the same recon planes."""
    from vcp_tpu_torch.codec.h264.frame_ops import pad_plane
    from vcp_tpu_torch.parallel.mesh import (encode_iframe_batch_sharded,
                                             make_mesh)
    planes = [np.stack([pad_plane(f[i], (16, 8, 8)[i])
                        for f in frames[:MESH_BATCH]]) for i in range(3)]
    got = {}
    for dev in (DEVICE, "cpu"):
        mesh = make_mesh(devices=[torch.device(dev)] * MESH_BATCH)
        t0 = time.monotonic()
        got[dev] = [p.cpu() for p in encode_iframe_batch_sharded(
            mesh, *planes, 26, 26)]
        log(f"  intra batch of {MESH_BATCH} frames over mesh "
            f"{mesh.shape} on {dev}: {time.monotonic() - t0:.3f} s")
    same = all(torch.equal(a, b) for a, b in zip(got[DEVICE], got["cpu"]))
    log(f"  intra batch {DEVICE} == cpu: {same}, shape "
        f"{tuple(got['cpu'][0].shape)}")
    if not same or got["cpu"][0].shape[0] != MESH_BATCH:
        raise AssertionError("encode_iframe_batch_sharded differs between "
                             f"{DEVICE} and cpu")


def mesh_phase4_jobs(frames, bq) -> dict:
    """Phase 4 of the mesh paths: the two mesh GOPs on 4 bands, {label:
    (fn, args)} for ``compare_devices``."""
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    return {"mesh-t4": (mesh_gop_on, (frames[:MESH_FRAMES],
                                      BUILTIN_PRESETS["h264-nvenc"], 4)),
            "mesh-cavlc-t4": (mesh_gop_on, (bq, MESH_Q_ARGS, 4,
                                            MESH_Q_ENV))}


def run_mesh_phase4(frames, bq, refs: dict | None = None) -> None:
    """Phase 4 of the mesh paths: ``cuda == cpu`` on the two mesh GOPs (4
    bands) and on the intra batch; ``refs`` the futures of their cpu
    sides, or None to run those here."""
    for label, (fn, args) in mesh_phase4_jobs(frames, bq).items():
        compare_devices(label, "mesh GOP", fn, args,
                        (refs or {}).get(label))
    check_iframe_batch(frames)


def run_mesh_only(frames, bq, t_start: float) -> int:
    """``--mesh-only``: the band checks of phase 2, phase 3f and its
    phase-4 checks and profile, for a short run after a change to the
    mesh; prints no result."""
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    dev = torch.device("cuda", 0)
    log("phase 2: the band form of the motion kernels at 1088x1920")
    check_motion_bands(dev, HP, W)
    by_path: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        log(f"phase 3f: the tile mesh ({time.monotonic() - t_start:.1f} s)")
        run_mesh(tmp, frames, bq, by_path)
    log(f"phase 4: mesh GOPs, cuda vs cpu ({time.monotonic() - t_start:.1f}"
        " s)")
    run_mesh_phase4(frames, bq)
    log(f"phase 5: mesh GOP profile ({time.monotonic() - t_start:.1f} s)")
    profile_gop("h264-nvenc", frames[:MESH_FRAMES],
                BUILTIN_PRESETS["h264-nvenc"])
    with mesh_on(4):
        profile_gop("mesh-t4", frames[:MESH_FRAMES],
                    BUILTIN_PRESETS["h264-nvenc"])
    log(f"mesh phases done at {time.monotonic() - t_start:.1f} s; launches "
        f"{by_path}")
    print("mesh only: no result")
    return 0


# ---------------------------------------------------------------------------
# Phase 3g: the bus
# ---------------------------------------------------------------------------

BUS_FRAMES = 40              # 1080p frames of bus-nvenc: IDRs at 0 and 24
BUS_CUT = 24                 # the background inverts here (a scene cut)
BUS_BOX = 256                # side of the moving box (luma pixels)
BUS_STEP = 8                 # its motion a frame (pixels across)
BUS_B_FRAMES = 10            # bus-bf2: two B GOPs of 5 (-g 5)
BUS_B_ARGS = ("-c:v h264_nvenc -preset p4 -bf 2 -g 5 -b:v 10M "
              "-movflags +faststart")
BUS_SYNTH_FRAMES = 9         # synth_frames content: IDR + a chunk of 8 P
BUS_DENSE = {"VCP_DELTA": "0", "VCP_SPARSE_B": "0"}


def synth_frames_static(h: int, w: int, n: int, cut: int, seed: int = 2):
    """A fixed textured background and a textured 256x256 box moving 8 px
    a frame across it (17 x 17 MBs change a frame), no noise; the
    background inverted from frame ``cut`` on (a scene cut)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float32)
    bg = [100 + 45 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
          + rng.integers(-20, 21, (h, w)),
          128 + 25 * np.sin(cx / 11.0), 128 + 25 * np.cos(cy / 9.0)]
    bg = [np.clip(p, 0, 255).astype(np.uint8) for p in bg]
    by, bx = np.mgrid[0:BUS_BOX, 0:BUS_BOX].astype(np.float32)
    box = [180 + 50 * np.sin(bx / 5.0) * np.cos(by / 7.0)
           + rng.integers(-15, 16, (BUS_BOX, BUS_BOX)),
           90 + rng.integers(-10, 11, (BUS_BOX // 2, BUS_BOX // 2)),
           170 + rng.integers(-10, 11, (BUS_BOX // 2, BUS_BOX // 2))]
    box = [np.clip(p, 0, 255).astype(np.uint8) for p in box]
    frames = []
    for t in range(n):
        planes = [255 - p if t >= cut else p.copy() for p in bg]
        x, y = 64 + BUS_STEP * t, 300           # y: not on an MB row
        for k, (p, b) in enumerate(zip(planes, box)):
            d = 2 if k else 1
            p[y // d:y // d + b.shape[0], x // d:x // d + b.shape[1]] = b
        frames.append(tuple(planes))
    return frames


@contextlib.contextmanager
def observe_bus(seen: dict):
    """While active, record without changing anything each P chunk's
    upload (frames, bytes of the device tensors its one upload made: the
    dense chunk buffer, or the delta's indices and tiles) and whether
    each P chunk's fetch overflowed its caps (a tail fetch)."""
    from vcp_tpu_torch.codec.h264 import gop_ops
    real = (gop_ops.encode_pchunk_delta, gop_ops.encode_pchunk_sparse,
            gop_ops.split_fetch)

    def delta(sy, su, sv, idx, tiles, *a, **kw):
        seen.setdefault("p_uploads", []).append(
            (idx.shape[0], idx.nbytes + tiles.nbytes))
        return real[0](sy, su, sv, idx, tiles, *a, **kw)

    def dense(buf, *a, **kw):
        seen.setdefault("p_uploads", []).append((buf.shape[0], buf.nbytes))
        return real[1](buf, *a, **kw)

    def split(arr, f, n_mb, mcap, pcap):
        out = real[2](arr, f, n_mb, mcap, pcap)
        seen.setdefault("p_tails", []).append(
            out[0] > mcap or out[1] > pcap)
        return out

    (gop_ops.encode_pchunk_delta, gop_ops.encode_pchunk_sparse,
     gop_ops.split_fetch) = delta, dense, split
    try:
        yield seen
    finally:
        (gop_ops.encode_pchunk_delta, gop_ops.encode_pchunk_sparse,
         gop_ops.split_fetch) = real


# host-to-device copies that no encode makes: they open and close the
# recorded window of a device profile
SENTINEL_BYTES = (4093, 4091)
SENTINEL_GAP_S = 0.25
# tiny launches before the opening sentinel: the first few device events
# of a recorded window can be missing from its trace, so these take the
# loss
PREROLL_LAUNCHES = 1000


@contextlib.contextmanager
def device_profile(cpu_ops: bool = False):
    """``torch.profiler`` over the body (the card's activity; with
    ``cpu_ops`` the host operators too). The recorded window starts with
    PREROLL_LAUNCHES tiny kernels, then a sentinel copy opens the body's
    part and another closes it, SENTINEL_GAP_S from the body on each
    side; ``trace_events`` keeps what lies between the two and fails
    unless both are there."""
    from torch.profiler import ProfilerActivity, profile

    def sentinel(n):
        torch.cuda.synchronize()
        time.sleep(SENTINEL_GAP_S)
        torch.zeros(n, dtype=torch.uint8).to(DEVICE)
        torch.cuda.synchronize()
        time.sleep(SENTINEL_GAP_S)

    acts = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cpu_ops else [])
    with profile(activities=acts) as prof:
        x = torch.zeros(1, device=DEVICE)
        for _ in range(PREROLL_LAUNCHES):
            x.add_(1)
        sentinel(SENTINEL_BYTES[0])
        yield prof
        sentinel(SENTINEL_BYTES[1])


def trace_events(prof) -> list[dict]:
    """The device events of a ``device_profile`` between its two sentinel
    copies, from Kineto's JSON export (one ``json.load``: torch's
    per-event Python objects, ``prof.events()``, took minutes for a GOP
    of a million launches)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)["traceEvents"]
    dev = [e for e in trace
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    span = [(e.get("ts"), e.get("dur")) for e in trace
            if e.get("cat") == "Trace"]
    del trace
    edges = []
    for n in SENTINEL_BYTES:
        at = [e["ts"] for e in dev
              if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", "")
              and e.get("args", {}).get("bytes") == n]
        if len(at) != 1:
            ts = [e["ts"] for e in dev] or [0]
            raise TraceLost(
                f"the device trace holds {len(at)} sentinel copies of {n} "
                f"bytes, not one ({len(dev)} device events from {min(ts)} "
                f"to {max(ts)}, trace span (ts, dur) {span})")
        edges.append(at[0])
    return [e for e in dev if edges[0] < e["ts"] < edges[1]]


class TraceLost(AssertionError):
    """A device trace that lacks a sentinel copy of its window."""


def profiled(label: str, run, cpu_ops: bool = False):
    """``run()`` under ``device_profile``: (its result, the device events
    between the sentinels, seconds to stop and read the trace). A trace
    that lost a sentinel is logged, and ``run`` goes once more under a
    fresh profile."""
    for attempt in (1, 2):
        with device_profile(cpu_ops) as prof:
            out = run()
            t_end = time.monotonic()
        try:
            events = trace_events(prof)
        except TraceLost as e:
            if attempt == 2:
                raise
            log(f"  {label}: {e}; running it again")
            continue
        return out, events, time.monotonic() - t_end


def memcpy_events(events: list[dict]) -> list[tuple[str, int]]:
    """(direction, bytes) of every device copy among ``trace_events``, in
    time order: h2d, d2h or d2d."""
    copies = sorted((e for e in events if e["cat"] == "gpu_memcpy"),
                    key=lambda e: e.get("ts", 0))
    out = []
    for e in copies:
        name = e.get("name", "")
        kind = next((k for k, tag in (("h2d", "HtoD"), ("d2h", "DtoH"),
                                      ("d2d", "DtoD")) if tag in name),
                    name)
        if "bytes" not in e.get("args", {}):
            raise AssertionError(f"memcpy event without bytes: {e}")
        out.append((kind, int(e["args"]["bytes"])))
    return out


def bus_bytes(label: str, copies: list, seen: dict, n_frames: int,
              n_gops: int, p_path: bool) -> dict:
    """H2D / D2H bytes and copies of one traced encode, per GOP, and per P
    frame of the P chunks: each chunk's upload must be one H2D copy of
    the recorded size. On the P path every chunk is fetched by one D2H
    copy (and one more when it overflows its caps) after the IDR's three
    (its count, meta and blocks): no other read of the counts."""
    h2d = [b for k, b in copies if k == "h2d"]
    d2h = [b for k, b in copies if k == "d2h"]
    ups = seen.get("p_uploads", [])
    pool = list(h2d)
    for _, b in ups:
        if b not in pool:
            raise AssertionError(f"{label}: no H2D copy of the {b} bytes of "
                                 f"a P chunk's upload (copies {h2d[:40]})")
        pool.remove(b)
    n_p = sum(n for n, _ in ups)
    tails = seen.get("p_tails", [])
    out = {"h2d_bytes": sum(h2d), "h2d_copies": len(h2d),
           "d2h_bytes": sum(d2h), "d2h_copies": len(d2h),
           "h2d_per_gop": sum(h2d) / n_gops, "d2h_per_gop": sum(d2h) / n_gops,
           "h2d_per_p_frame": sum(b for _, b in ups) / n_p if n_p else None,
           "p_chunks": len(ups), "tail_fetches": sum(tails)}
    log(f"  {label}: H2D {sum(h2d)} bytes in {len(h2d)} copies "
        f"({out['h2d_per_gop']:.1f} a GOP), D2H {sum(d2h)} bytes in "
        f"{len(d2h)} copies ({out['d2h_per_gop']:.1f} a GOP) over "
        f"{n_frames} frames; P chunks {len(ups)} ({n_p} frames, "
        f"{out['h2d_per_p_frame']} H2D bytes a P frame, each chunk one "
        f"copy), tail fetches {sum(tails)}")
    if p_path:
        want = 3 * n_gops + len(ups) + sum(tails)
        if len(d2h) != want:
            raise AssertionError(f"{label}: {len(d2h)} D2H copies, expected "
                                 f"{want}: 3 a GOP's IDR, one a P chunk, one "
                                 f"a tail")
    return out


def _bus_path(label: str, frames, tmp: str, cli_args: list[str],
              idrs: list[int], env: dict | None, cts=None,
              p_path: bool = True) -> tuple[dict, dict]:
    """One CLI encode of phase 3g under a device-only profiler: (launches,
    bytes). Its fps is taken under the profiler."""
    def run():
        seen: dict = {}
        with observe_bus(seen):
            launches, _ = run_main_path(
                label, frames, tmp, cli_args, idrs,
                ("motion_search", "deblock_fast", "deblock_general"),
                env=env, cts=cts)
        return launches, seen

    (launches, seen), events, _ = profiled(label, run)
    return launches, bus_bytes(label, memcpy_events(events), seen,
                               len(frames), len(idrs), p_path)


def run_bus(tmp: str, frames, by_path: dict) -> dict:
    """Phase 3g: what crosses the bus. Each pair encodes the same frames
    through the CLI with the delta upload and the sparse fetches (the
    defaults) and with ``VCP_DELTA=0`` (and ``VCP_SPARSE_B=0``): the NAL
    units must be equal. The static content must upload at most a tenth
    of the dense bytes a P frame, content where every tile changes at
    most 2 % more."""
    static = synth_frames_static(H, W, BUS_FRAMES, BUS_CUT)
    b_cts = gop_cts(5, 2) * 2
    pairs = (
        ("bus-nvenc", static, ["-p", "h264-nvenc"], [0, BUS_CUT], None,
         True),
        ("bus-bf2", static[:BUS_B_FRAMES], [f"--ffmpeg-args={BUS_B_ARGS}"],
         [0, 5], b_cts, False),
        ("bus-synth", frames[:BUS_SYNTH_FRAMES], ["-p", "h264-nvenc"], [0],
         None, True),
    )
    got = {}
    for label, fr, cli_args, idrs, cts, p_path in pairs:
        for lab, env in ((label, None), (f"{label}-dense", BUS_DENSE)):
            by_path[lab], got[lab] = _bus_path(lab, fr, tmp, cli_args, idrs,
                                               env, cts, p_path)
        same = video_samples(os.path.join(tmp, f"{label}.mp4")) == \
            video_samples(os.path.join(tmp, f"{label}-dense.mp4"))
        log(f"  {label}: video samples == {label}-dense's: {same}; launches "
            f"equal: {by_path[label] == by_path[label + '-dense']}; fps "
            f"{len(fr) / WALL_S[label]:.2f} against "
            f"{len(fr) / WALL_S[label + '-dense']:.2f} (under the profiler)")
        if not same:
            raise AssertionError(f"{label}: the delta and dense streams "
                                 "differ")
    for label, limit in (("bus-nvenc", 0.1), ("bus-synth", 1.02)):
        ratio = got[label]["h2d_per_p_frame"] / \
            got[f"{label}-dense"]["h2d_per_p_frame"]
        log(f"  {label}: H2D bytes a P frame {ratio:.4f}x the dense "
            f"upload's (limit {limit})")
        if not ratio <= limit:
            raise AssertionError(f"{label}: H2D a P frame {ratio:.4f}x "
                                 f"dense, limit {limit}")
    return got


def run_bus_only(t_start: float) -> int:
    """``--bus-only``: phase 3g and its phase-4 and phase-5 work, for a
    short run after a change to what crosses the bus; prints no result."""
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    frames = synth_frames(H, W, BUS_SYNTH_FRAMES, BUS_SYNTH_FRAMES)
    by_path: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        log(f"phase 3g: the bus ({time.monotonic() - t_start:.1f} s)")
        run_bus(tmp, frames, by_path)
    log(f"phase 4: the bus, cuda vs cpu ({time.monotonic() - t_start:.1f} "
        "s)")
    run_bus_phase4()
    log(f"phase 5: the bus, profiled GOPs ({time.monotonic() - t_start:.1f}"
        " s)")
    profile_gop("h264-nvenc", frames, BUILTIN_PRESETS["h264-nvenc"])
    run_bus_phase5()
    log(f"bus phases done at {time.monotonic() - t_start:.1f} s; launches "
        f"{by_path}")
    print("bus only: no result")
    return 0


def bus_phase4_job() -> tuple:
    """Phase 4 of the bus: two consecutive 3-frame GOPs of the static
    content through one encoder (the second IDR a delta), (fn, args) for
    ``compare_devices``: NAL units, last recon and delta carry."""
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    static = synth_frames_static(H, W, 6, BUS_CUT)
    return gops_on, ([static[:3], static[3:]], BUILTIN_PRESETS["h264-nvenc"])


def run_bus_phase4(cpu=None) -> None:
    """Phase 4 of the bus, ``cuda == cpu``; ``cpu`` the future of its cpu
    side, or None to run it here."""
    compare_devices("bus-nvenc", "two GOPs", *bus_phase4_job(), cpu)


def run_bus_phase5() -> None:
    """Phase 5 of the bus: the static content's 9-frame GOP profiled with
    the delta upload and without."""
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    static = synth_frames_static(H, W, 9, BUS_CUT)
    profile_gop("bus-nvenc", static, BUILTIN_PRESETS["h264-nvenc"])
    profile_gop("bus-nvenc-dense", static, BUILTIN_PRESETS["h264-nvenc"],
                env={"VCP_DELTA": "0"})


# ---------------------------------------------------------------------------
# Phase 3h: the host paths without the C++ library
# ---------------------------------------------------------------------------

NONATIVE = {"VCP_NO_NATIVE": "1"}
# (label, frames, CLI arguments, settings of both twins); the frames are
# the first of the speed path's content, or the B GOP's for h264-cpu
NONATIVE_PATHS = (
    ("nonative-nvenc", 3, ["-p", "h264-nvenc"], {}),
    ("nonative-cavlc", 2, ["-p", "h264-nvenc"], {"VCP_CABAC": "0"}),
    ("nonative-cpu", B_FRAMES, ["-p", "h264-cpu"], {}),
)
# the two decodes of an h264-cpu MP4, each in its own child
DECODE_WAYS = {"native": {}, "nonative": NONATIVE}


@contextlib.contextmanager
def observe_host_writers(seen: dict):
    """While active, the host seconds of every slice writer call by slice
    type (``entropy.write_islice`` / ``write_pslice``,
    ``bframe.write_bslice``: the native writers, or under
    ``VCP_NO_NATIVE=1`` the Python ones) and of the delta upload's tile
    pass (``gop_ops.tile_delta``)."""
    from vcp_tpu_torch.codec.h264 import bframe, entropy, gop_ops
    hooks = [(entropy, "write_islice", "I"), (entropy, "write_pslice", "P"),
             (bframe, "write_bslice", "B"), (gop_ops, "tile_delta", "tiles")]
    real = [getattr(m, k) for m, k, _ in hooks]

    def timer(key, fn):
        def call(*a, **kw):
            t = time.monotonic()
            out = fn(*a, **kw)
            seen.setdefault(key, []).append(time.monotonic() - t)
            return out
        return call

    for (m, k, key), fn in zip(hooks, real):
        setattr(m, k, timer(key, fn))
    try:
        yield seen
    finally:
        for (m, k, _), fn in zip(hooks, real):
            setattr(m, k, fn)


def _per_call(seen: dict) -> str:
    return ", ".join(
        f"{k} {sum(v) / len(v):.4f} s x{len(v)}" for k, v in seen.items())


def decode_digests(path: str, env: dict) -> tuple:
    """Decode an MP4 with the port's host decoder under the settings
    ``env`` (in a spawned child: the switches are read per picture):
    (per-frame sha256 of the Y, U, V planes, host seconds)."""
    import hashlib

    from vcp_tpu_torch.codec.ingest import open_video
    with scoped_env(env):
        t0 = time.monotonic()
        frames = list(open_video(path).frames)
        dt = time.monotonic() - t0
    return [hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes()
                                    for p in f)).hexdigest()
            for f in frames], dt


def submit_nonative_decodes(path: str) -> tuple:
    """Start the decodes of ``path`` (``DECODE_WAYS``) in spawned
    children, beside the card's later work: (pool, {way:
    future}, directory of the copy)."""
    import concurrent.futures
    import multiprocessing
    import shutil
    keep = tempfile.mkdtemp(prefix="nonative_decode_")
    copy = os.path.join(keep, os.path.basename(path))
    shutil.copyfile(path, copy)
    pool = concurrent.futures.ProcessPoolExecutor(
        len(DECODE_WAYS), mp_context=multiprocessing.get_context("spawn"))
    return pool, {way: pool.submit(decode_digests, copy, env)
                  for way, env in DECODE_WAYS.items()}, keep


def finish_nonative_decodes(job, n_frames: int) -> None:
    """Wait for the decodes: the same frames every way."""
    import shutil
    pool, futures, keep = job
    t0 = time.monotonic()
    try:
        got = {way: f.result() for way, f in futures.items()}
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(keep, ignore_errors=True)
    for way, (digests, dt) in got.items():
        log(f"  h264-cpu decode {way} {DECODE_WAYS[way]}: "
            f"{len(digests)} frames in {dt:.3f} s ({dt / len(digests):.3f} "
            f"s per frame)")
    ref = got["native"][0]
    log(f"  h264-cpu decodes: waited {time.monotonic() - t0:.1f} s; "
        "frames equal to the native decode's: "
        f"{ {w: d == ref for w, (d, _) in got.items()} }")
    if len(ref) != n_frames or any(d != ref for d, _ in got.values()):
        raise AssertionError("h264-cpu: the decodes differ")


def run_nonative_encodes(tmp: str, frames, bq, by_path: dict) -> None:
    """``--nonative-only``: each path of ``NONATIVE_PATHS`` through the
    CLI on the card, natively and under ``VCP_NO_NATIVE=1`` (the Python
    and NumPy host paths; the device work is the same): equal NAL units
    and equal launches of every kernel, kernels 1, 3 and 4 launched.
    Logs the host seconds per frame of each slice writer and of the tile
    pass, both ways."""
    for label, n, cli_args, env in NONATIVE_PATHS:
        b_gop = label == "nonative-cpu"
        fr = bq if b_gop else frames[:n]
        cts = gop_cts(n, 2) if b_gop else None
        kernels = ("deblock_fast", "deblock_general") if b_gop else (
            "motion_search", "deblock_fast", "deblock_general")
        timing, samples = {}, {}
        for lab, extra in ((f"{label}-native", {}), (label, NONATIVE)):
            seen: dict = {}
            with observe_host_writers(seen):
                by_path[lab], _ = run_main_path(
                    lab, fr, tmp, cli_args, [0], kernels,
                    env={**env, **extra}, cts=cts)
            timing[lab] = seen
            samples[lab] = video_samples(os.path.join(tmp, f"{lab}.mp4"))
            log(f"  {lab}: host s per call {_per_call(seen)}")
        twin = f"{label}-native"
        same = samples[label] == samples[twin]
        log(f"  {label}: NAL units == {twin}'s: {same}; launches "
            f"{by_path[label]} (native {by_path[twin]})")
        if not same or by_path[label] != by_path[twin]:
            raise AssertionError(f"{label}: stream or launches differ from "
                                 "the native twin's")
        if label == "nonative-cavlc" and not cavlc_mp4(
                os.path.join(tmp, f"{label}.mp4")):
            raise AssertionError(f"{label}: not a CAVLC stream")


def run_nonative_only(t_start: float) -> int:
    """``--nonative-only``: the encodes without the C++ library and
    phase 3h's decodes of their ``h264-cpu`` MP4; prints no result."""
    frames = synth_frames(H, W, 3, 3)
    bq = synth_frames_subpel(H, W, B_FRAMES, B_FRAMES)
    by_path: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 3h: the host paths without the C++ library "
            f"({time.monotonic() - t_start:.1f} s)")
        run_nonative_encodes(tmp, frames, bq, by_path)
        job = submit_nonative_decodes(os.path.join(tmp, "nonative-cpu.mp4"))
        finish_nonative_decodes(job, B_FRAMES)
    log(f"nonative phase done at {time.monotonic() - t_start:.1f} s; "
        f"launches {by_path}")
    print("nonative only: no result")
    return 0


# ---------------------------------------------------------------------------
# Phase 4: cuda vs cpu on one GOP of each path
# ---------------------------------------------------------------------------

REF_WORKERS = 3              # spawned children that run phase 4's cpu sides
REF_THREADS = 2              # torch threads in each of them


def _ref_init() -> None:
    torch.set_num_threads(REF_THREADS)


def start_cpu_refs(jobs: dict) -> tuple:
    """Start the cpu sides of phase 4, {label: (fn, args)}, in order in
    REF_WORKERS spawned children (they share no CUDA state with this
    process and use no card), beside this process's device sides:
    (pool, {label: future}). ``pool.shutdown`` stops them."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        REF_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_ref_init)
    return pool, {k: pool.submit(fn, "cpu", *args)
                  for k, (fn, args) in jobs.items()}


def _h264_encoder(dev: str, frames, ffargs: str):
    from vcp_tpu_torch.codec.args import parse_encode_args
    from vcp_tpu_torch.codec.h264.encoder import EncoderConfig, H264Encoder
    h, w = frames[0][0].shape
    cfg = EncoderConfig.from_params(parse_encode_args(ffargs), w, h, 30, 1)
    return cfg, H264Encoder(cfg, device=dev)


def _stages(enc) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in enc.stage_s.items())


def gop_on(dev: str, frames, ffargs: str, env: dict | None = None):
    """One GOP through one H.264 encoder on ``dev`` under the settings
    ``env``: (NAL units, [last recon planes], log line)."""
    with scoped_env(env):
        cfg, enc = _h264_encoder(dev, frames, ffargs)
        t0 = time.monotonic()
        out = enc.encode_gop(frames)
        secs = time.monotonic() - t0
    return (out, list(enc.recon_planes), f"{secs:.3f} s, qp {cfg.qp}, B "
            f"pictures {cfg.bframes} ({_stages(enc)})")


def mesh_gop_on(dev: str, frames, ffargs: str, n_tile: int,
                env: dict | None = None):
    """One GOP over a mesh of ``n_tile`` x ``dev``: (NAL units, [last
    recon planes], log line)."""
    from vcp_tpu_torch.parallel.mesh import make_mesh
    with scoped_env(env):
        _, enc = _h264_encoder(dev, frames, ffargs)
        mesh = make_mesh(n_tile, data=1, tile=n_tile,
                         devices=[enc.device] * n_tile)
        t0 = time.monotonic()
        out = enc._encode_gop_mesh(frames, mesh)
        secs = time.monotonic() - t0
    return out, list(enc.recon_planes), f"{secs:.3f} s, {n_tile} bands"


def gops_on(dev: str, gops, ffargs: str, env: dict | None = None):
    """GOPs in turn through one H.264 encoder on ``dev``: (NAL units,
    [last recon planes, host tiles and device source of the delta carry],
    log line)."""
    with scoped_env(env):
        _, enc = _h264_encoder(dev, gops[0], ffargs)
        t0 = time.monotonic()
        out = [s for g in gops for s in enc.encode_gop(g)]
        secs = time.monotonic() - t0
    state = [*enc.recon_planes, enc._prev_tiles,
             *(p.cpu().numpy() for p in enc._src_dev)]
    return out, state, f"{secs:.3f} s for GOPs of {[len(g) for g in gops]}"


def hevc_on(dev: str, frames, ffargs: str, env: dict | None = None):
    """IDR + P frames through one HEVC encoder on ``dev``: (NAL units, [],
    log line)."""
    from vcp_tpu_torch.codec.args import parse_encode_args
    from vcp_tpu_torch.codec.h265.encoder import (HevcEncoder,
                                                  HevcEncoderConfig)
    h, w = frames[0][0].shape
    with scoped_env(env):
        cfg = HevcEncoderConfig.from_params(parse_encode_args(ffargs), w, h,
                                            30, 1)
        enc = HevcEncoder(cfg, device=dev)
        t0 = time.monotonic()
        out = [enc.encode_frame(*f) for f in frames]
        secs = time.monotonic() - t0
    return out, [], (f"{secs:.3f} s, qp {cfg.qp}, RD intra "
                     f"{cfg.use_rd_intra()} ({_stages(enc)})")


def compare_devices(label: str, what: str, fn, args: tuple, cpu=None,
                    count: tuple[str, ...] = ()):
    """``fn(DEVICE, *args)`` here and ``fn("cpu", *args)`` (the future
    ``cpu`` of a child, or here when None): the same NAL units and state
    arrays. The kernels named in ``count`` must launch on the device side
    (logged). Returns the device side's state arrays."""
    counters = {k: launch_counters()[k] for k in count}
    before = {k: getattr(fn_, a) for k, (fn_, a) in counters.items()}
    out, state, line = fn(DEVICE, *args)
    launched = {k: getattr(fn_, a) - before[k]
                for k, (fn_, a) in counters.items()}
    log(f"  {label} {what} on {DEVICE}: {line}"
        + (f", launches {launched}" if count else ""))
    if not all(launched.values()):
        raise AssertionError(f"{label}: kernels not launched {launched}")
    ref_out, ref_state, ref_line = cpu.result() if cpu is not None \
        else fn("cpu", *args)
    log(f"  {label} {what} on cpu: {ref_line}")
    same = out == ref_out
    same_state = len(state) == len(ref_state) and all(
        np.array_equal(a, b) for a, b in zip(state, ref_state))
    log(f"  {label}: NAL units {DEVICE} == cpu: {same} ({len(out)} access "
        f"units, {sum(len(x[0]) for x in out)} bytes), state equal: "
        f"{same_state}")
    if not (same and same_state):
        raise AssertionError(f"{label}: {DEVICE} and cpu differ")
    return state


def check_devices(label: str, frames, ffargs: str,
                  count: tuple[str, ...] = (), cpu=None) -> None:
    """One GOP on cuda and on cpu (``gop_on`` under the VCP_* settings of
    the moment): the same NAL units and last recon, and the last frame's
    recon above PSNR_FLOOR_DB. The kernels named in ``count`` must launch
    in the cuda run (logged)."""
    env = {k: v for k, v in os.environ.items() if k.startswith("VCP_")}
    recon = compare_devices(label, f"GOP ({len(frames)} frames)", gop_on,
                            (frames, ffargs, env), cpu, count)
    ry = recon[0].astype(np.float64)
    mse = float(np.mean((ry - frames[-1][0].astype(np.float64)) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log(f"  recon luma PSNR of the last frame: {psnr:.2f} dB "
        f"(floor {PSNR_FLOOR_DB})")
    if not psnr > PSNR_FLOOR_DB:
        raise AssertionError(f"PSNR {psnr:.2f} dB below floor")


def check_pyramid_pstep(frames) -> None:
    """One half-pel P frame with the pyramid search (plain tensor code on
    both devices) from the same reference: cuda == cpu."""
    from vcp_tpu_torch.codec.h264 import gop_ops
    from vcp_tpu_torch.codec.h264.frame_ops import pad_plane
    planes = [[pad_plane(p, a) for p, a in zip(f, (16, 8, 8))]
              for f in frames[:2]]
    h, w = planes[0][0].shape
    buf = gop_ops.pack_frames([planes[1]])
    out = {}
    for dev in (DEVICE, "cpu"):
        ref = [torch.from_numpy(p).to(dev) for p in planes[0]]
        res = gop_ops.encode_pchunk_sparse(
            torch.from_numpy(buf).to(dev), *ref, 24, 24, Q_SR, 8, h, w,
            True, 1, True)
        out[dev] = [t.cpu() for t in res]
    mc, bc = (int(c) for c in out["cpu"][1])
    same = all(torch.equal(a[:n], b[:n]) for a, b, n in zip(
        out[DEVICE], out["cpu"], (None, None, mc, bc, None, None, None)))
    log(f"  pyramid-search P frame cuda == cpu: {same} ({mc} active MBs)")
    if not same:
        raise AssertionError("pyramid-search P frame differs between "
                             "cuda and cpu")


def check_devices_hevc(label: str, frames, ffargs: str, cpu=None) -> None:
    """IDR + P frames of the HEVC encoder on cuda and on cpu: the same NAL
    units, and none of the four kernels launched."""
    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    compare_devices(label, f"IDR + {len(frames) - 1} P", hevc_on,
                    (frames, ffargs), cpu)
    launched = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
    log(f"  {label}: launches {launched}")
    no_launches(label, launched)


def profile_hevc(label: str, frames, ffargs: str) -> None:
    """Device time of IDR + P frames of the HEVC encoder on cuda (device
    activity only), the idle share, and the host seconds of the CABAC
    slice writer, timed by wrapping ``syntax.encode_slice_data`` here."""
    from torch.profiler import ProfilerActivity, profile
    from vcp_tpu_torch.codec.args import parse_encode_args
    from vcp_tpu_torch.codec.h265 import syntax
    from vcp_tpu_torch.codec.h265.encoder import (HevcEncoder,
                                                  HevcEncoderConfig)
    h, w = frames[0][0].shape
    cfg = HevcEncoderConfig.from_params(parse_encode_args(ffargs), w, h,
                                        30, 1)
    enc = HevcEncoder(cfg, device=DEVICE)
    real = syntax.encode_slice_data
    cabac: list[float] = []

    def timed(*a, **kw):
        t = time.monotonic()
        r = real(*a, **kw)
        cabac.append(time.monotonic() - t)
        return r

    syntax.encode_slice_data = timed
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for f in frames:
                enc.encode_frame(*f)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        syntax.encode_slice_data = real
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)["traceEvents"]
    by_name: dict[str, list] = {}
    for e in trace:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            acc = by_name.setdefault(e["name"], [0, 0.0])
            acc[0] += 1
            acc[1] += e.get("dur", 0) / 1e3
    busy = sum(v[1] for v in by_name.values())
    n = sum(v[0] for v in by_name.values())
    if n == 0:
        raise AssertionError("the profiler saw no device activity")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in enc.stage_s.items())
    log(f"  profiled {label} IDR + {len(frames) - 1} P: wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms over {n} device "
        f"kernels/copies (idle share {1 - busy / (wall * 1e3):.3f}); host "
        f"CABAC (syntax.encode_slice_data) {sum(cabac):.3f} s "
        f"({', '.join(f'{c:.3f}' for c in cabac)} s per frame); {stages}")
    for name, (cnt, ms) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:10]:
        log(f"    {ms:9.3f} ms {cnt:6d}x  {name[:90]}")


def profile_gop(label: str, frames, ffargs: str, cpu_ops: bool = True,
                env: dict | None = None) -> None:
    """Device time of one GOP on cuda, by kernel, from torch.profiler; the
    wall clock includes the profiler's overhead. ``cpu_ops=False`` traces
    the device side only (a GOP with several hundred thousand launches).
    Fails unless every deblock wrapper call of the GOP shows as exactly
    one ``deblock_wave`` device kernel and no per-diagonal reference
    kernel ran."""
    from vcp_tpu_torch.codec.args import parse_encode_args
    from vcp_tpu_torch.codec.h264.encoder import EncoderConfig, H264Encoder
    h, w = frames[0][0].shape
    counters = [launch_counters()[k] for k in (
        "deblock_fast", "deblock_general", "deblock_general_no_strong")]

    def run():
        enc = H264Encoder(cfg, device="cuda")
        calls = -sum(getattr(fn, attr) for fn, attr in counters)
        t0 = time.monotonic()
        enc.encode_gop(frames)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        return enc, wall, calls + sum(getattr(fn, attr)
                                      for fn, attr in counters)

    with scoped_env(env):
        cfg = EncoderConfig.from_params(parse_encode_args(ffargs), w, h, 30,
                                        1)
        (enc, wall, calls), events, read_s = profiled(label, run, cpu_ops)
    by_name: dict[str, list] = {}
    for e in events:
        acc = by_name.setdefault(e["name"], [0, 0.0])
        acc[0] += 1
        acc[1] += e.get("dur", 0) / 1e3
    nbytes = {k: sum(b for d, b in memcpy_events(events) if d == k)
              for k in ("h2d", "d2h")}
    del events
    busy = sum(v[1] for v in by_name.values())
    n = sum(v[0] for v in by_name.values())
    if n == 0:
        raise AssertionError("the profiler saw no device activity")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in enc.stage_s.items())
    log(f"  profiled {label} GOP ({len(frames)} frames): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms over {n} device "
        f"kernels/copies (idle share {1 - busy / (wall * 1e3):.3f}); "
        f"H2D {nbytes['h2d']} bytes, D2H {nbytes['d2h']} bytes; "
        f"{stages}; trace stopped and read in {read_s:.1f} s")
    for name, (cnt, ms) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:10]:
        log(f"    {ms:9.3f} ms {cnt:6d}x  {name[:90]}")
    wave = [v for k, v in by_name.items() if "deblock_wave" in k]
    n_wave, n_diag = sum(v[0] for v in wave), sum(
        v[0] for k, v in by_name.items() if "deblock_diag" in k)
    log(f"    deblock: {calls} wrapper calls, {n_wave} deblock_wave device "
        f"kernels ({sum(v[1] for v in wave):.3f} ms), {n_diag} "
        f"deblock_diag kernels")
    if calls == 0 or n_wave != calls or n_diag:
        raise AssertionError(
            f"{label}: {calls} deblock calls but {n_wave} deblock_wave and "
            f"{n_diag} deblock_diag device kernels")


def run_hevc_only(frames, hframes, t_start: float) -> int:
    """``--hevc-only``: phases 3c, 4 and 5 of the HEVC paths alone (the
    hq path from an MP4 + AAC of 12 frames of the speed path), for a
    short run after a change to the HEVC engine; prints no result."""
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    by_path: dict = {}
    decodes: list = []
    with tempfile.TemporaryDirectory() as tmp:
        run_main_path("h264-nvenc", frames, tmp, ["-p", "h264-nvenc"],
                      [0], ("motion_search",))
        av = make_av_inputs(tmp, os.path.join(tmp, "h264-nvenc.mp4"))
        log(f"phase 3c: HEVC ({time.monotonic() - t_start:.1f} s)")
        run_hevc(tmp, hframes, av["paths"]["mp4-aac"], frames, av, by_path,
                 decodes)
    for preset in ("h265-nvenc", "h265-cpu"):
        check_devices_hevc(preset, hframes[:3], BUILTIN_PRESETS[preset])
    profile_hevc("h265-cpu", hframes[:3], BUILTIN_PRESETS["h265-cpu"])
    finish_decodes(decodes)
    log(f"HEVC phases done at {time.monotonic() - t_start:.1f} s; "
        f"launches {by_path}")
    print("hevc only: no result")
    return 0


def run_control_only(card: str, t_start: float) -> int:
    """``--control-only``: phase 3d alone, on a fresh 40-frame Y4M and its
    own MP4 + AAC (the direct encodes it compares with run first)."""
    frames = synth_frames(H, W, N_FRAMES, SCENE_CUT)
    kernels = ("motion_search", "deblock_fast", "deblock_general")
    by_path: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        run_main_path("h264-nvenc", frames, tmp, ["-p", "h264-nvenc"],
                      [0, SCENE_CUT], kernels)
        av = make_av_inputs(tmp, os.path.join(tmp, "h264-nvenc.mp4"))
        run_main_path("mp4-aac", frames, tmp, ["-p", "h264-nvenc"],
                      [0, SCENE_CUT], kernels, src=av["paths"]["mp4-aac"])
        log(f"phase 3d: control plane ({time.monotonic() - t_start:.1f} s)")
        run_control_plane(tmp, av, by_path)
    log(f"control phase done at {time.monotonic() - t_start:.1f} s; "
        f"launches {by_path}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phase4(frames, qframes, bq, hframes) -> None:
    """Phase 4: ``cuda == cpu`` on one GOP of each path. Every cpu side
    starts at once in child processes (``start_cpu_refs``); the device
    sides run here in the same order and wait for theirs."""
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    hier0 = {"VCP_HIER_ME": "0"}
    cavlc0 = {**CAVLC_CPU_ENV, "VCP_HIER_ME": "0"}
    gops = {
        "h264-nvenc": (frames[:9], BUILTIN_PRESETS["h264-nvenc"], {}, ()),
        "medium-bf0-exhaustive": (qframes[:3], Q_ARGS, hier0, ()),
        # IDR, P3, B1, B2
        "h264-cpu-exhaustive": (bq[:4], BUILTIN_PRESETS["h264-cpu"], hier0,
                                ()),
        # the search-only kernel at +-16 on both B lists, quarter-pel
        # partitions on the anchor
        "h264-nvenc-hq-exhaustive": (bq[:4], BUILTIN_PRESETS["h264-nvenc-hq"],
                                     hier0, ("motion_search_only",)),
        # IDR (I16-only RD), P3, B1, B2 through the CAVLC writers
        "cavlc-cpu-exhaustive": (bq[:4], BUILTIN_PRESETS["h264-cpu"], cavlc0,
                                 ("motion_search_only",)),
        # IDR + 1 P: the chunked quarter-pel P path
        "p7-bf0": (qframes[:2], P7_ARGS, {}, ()),
    }
    hevc = {p: (hevc_on, (hframes[:3], BUILTIN_PRESETS[p]))
            for p in ("h265-nvenc", "h265-cpu")}
    pool, refs = start_cpu_refs({
        **{k: (gop_on, (fr, args, env)) for k, (fr, args, env, _)
           in gops.items()},
        **hevc, **mesh_phase4_jobs(frames, bq),
        "bus-nvenc": bus_phase4_job()})
    try:
        for label, (fr, args, env, count) in gops.items():
            with scoped_env(env):
                check_devices(label, fr, args, count, refs[label])
        check_pyramid_pstep(qframes)
        for preset, (_, (fr, args)) in hevc.items():
            check_devices_hevc(preset, fr, args, refs[preset])
        run_mesh_phase4(frames, bq, refs)
        run_bus_phase4(refs["bus-nvenc"])
    finally:
        pool.shutdown(cancel_futures=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from vcp_tpu_torch import device as devmod
    from vcp_tpu_torch import native
    from vcp_tpu_torch.config import BUILTIN_PRESETS

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.monotonic()
    # the kernels and the SAD sequence microbenchmark, one nvcc each
    devmod.build_kernels(devmod.SOURCES + ("motion_probe.cu",))
    for src in devmod.SOURCES:
        devmod.kernel_lib(src)
    log(f"kernels built in {time.monotonic() - t0:.1f} s")
    # the host library too (CABAC writers, the MP4 decoder's parser,
    # reconstruction and deblock), so that no main path's clock holds a
    # compiler run
    t0 = time.monotonic()
    native.get_lib()
    log(f"host library built in {time.monotonic() - t0:.1f} s")
    if "--hevc-only" in argv:
        return run_hevc_only(synth_frames(H, W, 12, 12),
                             synth_frames_subpel(H, W, HEVC_FRAMES,
                                                 HEVC_CUT), t_start)
    if "--control-only" in argv:
        return run_control_only(card, t_start)
    if "--cavlc-only" in argv:
        return run_cavlc_only(synth_frames(H, W, CAVLC_FRAMES, CAVLC_FRAMES),
                              synth_frames_subpel(H, W, B_FRAMES, B_FRAMES),
                              t_start)
    if "--mesh-only" in argv:
        return run_mesh_only(synth_frames(H, W, MESH_FRAMES, MESH_FRAMES),
                             synth_frames_subpel(H, W, B_FRAMES, B_FRAMES),
                             t_start)
    if "--bus-only" in argv:
        return run_bus_only(t_start)
    if "--nonative-only" in argv:
        return run_nonative_only(t_start)

    log("phase 2: kernels vs plain versions at 1088x1920")
    rows = [*check_motion(dev, HP, W, reps=20),
            check_deblock_fast(dev, HP, W, reps=20),
            check_deblock_general(dev, HP, W, reps=20),
            check_deblock_general_no_strong(dev, HP, W, reps=20)]
    bands = check_motion_bands(dev, HP, W)
    for row in rows:
        row.update(bands.get(row["name"], {}))
    torch.cuda.synchronize()
    for row in rows:
        log(f"  {row['name']}: {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.5f} ms by "
            f"{row['bound_by']})" + (
                f", per-diagonal reference {row['diag_ms']:.4f} ms, "
                f"{row['step_us']:.3f} us per step of {row['d_steps']}"
                if "diag_ms" in row else "") + (
                f", reference design {row['ref_ms']:.4f} ms, "
                f"{row['po_per_sm_clock']:.1f} pixel-offsets per SM clock "
                f"(reference {row['ref_po_per_sm_clock']:.1f}, bound "
                f"{row['bound_po_per_sm_clock']:.1f}); 2160x3840 "
                f"{row['ms_2160x3840']:.4f} ms, reference "
                f"{row['ref_ms_2160x3840']:.4f}, plan {row['plan']}"
                if "ref_ms" in row else ""))
    log("phase 2b: the one-launch deblock kernels at shapes that stress "
        "the schedule, and against the per-diagonal reference")
    check_deblock_shapes(dev)
    race_hunt(dev, HP, W)
    race_hunt(dev, *STRESS_SHAPES[-1], n_random=16, n_repeat=4)
    log(f"  kernel phases done at {time.monotonic() - t_start:.1f} s")
    torch.cuda.synchronize()
    if "--kernels-only" in argv:
        print("kernels only: main paths not driven, no result")
        return 0

    log(f"phase 3: main paths, cli encode on cuda "
        f"({time.monotonic() - t_start:.1f} s)")
    frames = synth_frames(H, W, N_FRAMES, SCENE_CUT)
    hframes = synth_frames_subpel(H, W, HEVC_FRAMES, HEVC_CUT)
    qframes = synth_frames_subpel(H, W, Q_FRAMES, Q_CUT)
    bq = synth_frames_subpel(H, W, B_FRAMES, B_FRAMES)
    q_cli = [f"--ffmpeg-args={Q_ARGS}"]
    by_path = {}
    decodes: list = []
    with tempfile.TemporaryDirectory() as tmp:
        by_path["h264-nvenc"], _ = run_main_path(
            "h264-nvenc", frames, tmp, ["-p", "h264-nvenc"],
            [0, SCENE_CUT],
            ("motion_search", "deblock_fast", "deblock_general"))
        by_path["medium-bf0"], seen = run_main_path(
            "medium-bf0", qframes, tmp, q_cli, [0, Q_CUT],
            ("deblock_fast", "deblock_general"))
        check_quality_tools("medium-bf0", seen)
        log_writers("medium-bf0", seen, len(qframes))
        by_path["medium-bf0-exhaustive"], seen = run_main_path(
            "medium-bf0-exhaustive", qframes, tmp, q_cli, [0, Q_CUT],
            ("motion_search_only", "deblock_fast", "deblock_general"),
            env={"VCP_HIER_ME": "0"})
        check_quality_tools("medium-bf0-exhaustive", seen)
        # one GOP, 2 B pictures
        b_cts = gop_cts(B_FRAMES, 2)
        for label, env, kernels in (
                ("h264-cpu", None, ("deblock_fast", "deblock_general")),
                ("h264-cpu-exhaustive", {"VCP_HIER_ME": "0"},
                 ("motion_search_only", "deblock_fast", "deblock_general"))):
            by_path[label], seen = run_main_path(
                label, bq, tmp, ["-p", "h264-cpu"], [0], kernels,
                env=env, cts=b_cts)
            check_quality_tools(label, seen)
            check_b_tools(label, seen)
        by_path["nvenc-bf2"], _ = run_main_path(
            "nvenc-bf2", synth_frames(H, W, B_FRAMES, B_FRAMES), tmp,
            [f"--ffmpeg-args={NVENC_B_ARGS}"], [0],
            ("motion_search", "deblock_fast", "deblock_general"), cts=b_cts)
        # a real MP4 input: the h264-cpu path's file (High profile, CABAC,
        # B pictures, partitions, 8x8 transform), decoded on the host
        cpu_mp4 = os.path.join(tmp, "h264-cpu.mp4")
        check_decoder(cpu_mp4, bq)
        by_path["h264-nvenc-hq"], seen = run_main_path(
            "h264-nvenc-hq", bq, tmp, ["-p", "h264-nvenc-hq"], [0],
            ("deblock_fast", "deblock_general"), cts=b_cts, src=cpu_mp4)
        check_quality_tools("h264-nvenc-hq", seen)
        check_qpel_tools("h264-nvenc-hq", seen)
        check_b_tools("h264-nvenc-hq", seen)
        log("phase 3b: containers, audio, copy, scaling "
            f"({time.monotonic() - t_start:.1f} s)")
        av = run_containers(tmp, frames, by_path)
        check_resize(dev)
        log(f"phase 3c: HEVC ({time.monotonic() - t_start:.1f} s)")
        run_hevc(tmp, hframes, av["paths"]["mp4-aac"], frames, av, by_path,
                 decodes)
        log("phase 3d: control plane, redis-serve + 2 producers + a "
            f"consumer on cuda ({time.monotonic() - t_start:.1f} s)")
        run_control_plane(tmp, av, by_path)
        log("phase 3e: CAVLC and the I16 RD IDR "
            f"({time.monotonic() - t_start:.1f} s)")
        run_cavlc(tmp, frames, bq, by_path)
        log(f"phase 3f: the tile mesh ({time.monotonic() - t_start:.1f} s)")
        run_mesh(tmp, frames, bq, by_path)
        log(f"phase 3g: the bus ({time.monotonic() - t_start:.1f} s)")
        run_bus(tmp, frames, by_path)
        log("phase 3h: decodes without the C++ library, beside the "
            f"later phases ({time.monotonic() - t_start:.1f} s)")
        nonative_decodes = submit_nonative_decodes(cpu_mp4)

    log(f"phase 4: one GOP, cuda vs cpu ({time.monotonic() - t_start:.1f} "
        "s)")
    run_phase4(frames, qframes, bq, hframes)
    log("phase 5: device time of one GOP on cuda (torch.profiler; "
        f"{time.monotonic() - t_start:.1f} s)")
    profile_gop("h264-nvenc", frames[:9], BUILTIN_PRESETS["h264-nvenc"])
    with mesh_on(4):
        profile_gop("mesh-t4", frames[:MESH_FRAMES],
                    BUILTIN_PRESETS["h264-nvenc"])
    profile_gop("medium-bf0-exhaustive", qframes[:3], Q_ARGS, cpu_ops=False,
                env={"VCP_HIER_ME": "0"})
    profile_gop("h264-cpu-exhaustive", bq[:4],
                BUILTIN_PRESETS["h264-cpu"], cpu_ops=False,
                env={"VCP_HIER_ME": "0"})
    profile_hevc("h265-cpu", hframes[:3], BUILTIN_PRESETS["h265-cpu"])
    run_bus_phase5()
    finish_decodes(decodes)
    finish_nonative_decodes(nonative_decodes, B_FRAMES)

    for row in rows:
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        log(f"  {row['name']}: {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.5f} ms by "
            f"{row['bound_by']}), launches {row['launches']} "
            f"{row['launches_by_path']}")
    log(f"all phases done at {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
