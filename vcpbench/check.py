"""The comparison that decides ``correct``, and ``psnr_db`` / ``kbps``.

It judges the outputs of a run's tasks at three layers, with code of the
benchmark's own (``mp4read``, the reference decoder ``h264ref``, the
content generator) and nothing of the port. A task that failed, or whose
output ``verify_video_file`` refused, counts in ``tasks_failed``
(``bench.py``); the others are judged:

* the outputs themselves: every task encodes the same clip with a fresh
  encoder, and the port is deterministic (``cuda == cpu`` to the byte),
  so each output must equal the sampled one byte for byte
  (``outputs_differ``);
* the MP4 container of the sampled output (``container_faults``): one
  ``avc1`` track of the configuration's size, one sample a frame, each
  frame's duration, sync samples exactly at the GOP starts, ``moov``
  before ``mdat``, one slice NAL unit a sample (IDR on sync samples);
* the H.264 bitstream: every frame's slice parsed by the reference to
  its end (``syntax_faults``), and the first ``pixel_frames_per_gop``
  frames of every GOP decoded to pictures and compared with the seed's
  source frames. The decode follows the stream from each IDR, so it
  judges what the device computed: motion search, transform and
  quantisation, intra decisions and the in-loop filter.

The pictures are judged by ``lowpass_mse``: the worst, over the decoded
frames, of the mean squared error between the means of the decoded and
the source luma samples over each 8x8 block; ``lowpass16_mse`` is the
same over 16x16 blocks. The sources carry white noise that no encode at
these rates keeps; averaging takes it out of both sides, so the number
reads what coding lost of the picture itself. A cell compares the one
of the two that its limits file names, the one by which a quantiser one
bit coarser reads three times as much or more; the other is reported.
The plain worst mean squared error of a plane, chroma included
(``mse_worst``), is reported beside them and not compared: the noise
holds it near its floor, and the coarser quantiser moves it by half.

A configuration under average-bit-rate control sets ``compared_gops``:
``lowpass_mse`` then reads the decoded frames of that many GOPs from the
start, those coded at the quantiser that the configuration's rate sets.
Rate control re-centres every later GOP on the rate it measured, which
pulls a coarser control back towards the program. The frames of later
GOPs are decoded all the same: a failure there is a syntax fault, and
their error is in ``mse_worst`` and ``psnr_db``.

The frames are spread over a pool of spawned worker processes: the
pixel runs from each IDR first, then one parse per remaining frame.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os

import numpy as np

from . import mp4read
from .content import Content, seed64

COUNTS = ("tasks_failed", "outputs_differ", "container_faults",
          "syntax_faults")
# the picture numbers: name -> side of the averaged luma blocks
PICTURES = {"lowpass_mse": 8, "lowpass16_mse": 16}
NUMBERS = COUNTS + tuple(PICTURES)
MSE_MAX = 255.0 ** 2          # the reading of a frame that never decoded
_SAMPLE = 0xC4EC


def gop_starts(n: int, gop: int) -> list[int]:
    return list(range(0, n, gop))


def container_faults(movie: mp4read.Movie, data: bytes, cfg: dict,
                     n_frames: int) -> list[str]:
    """What the sampled output breaks of the container the configuration
    states; an empty list when nothing."""
    faults = []
    names = [t for t, _, _ in movie.top]
    if "moov" not in names or "mdat" not in names:
        return [f"top-level boxes {names}: no moov or mdat"]
    if cfg["faststart"] and names.index("moov") > names.index("mdat"):
        faults.append("moov after mdat (faststart)")
    vids = [t for t in movie.tracks if t.handler == "vide"]
    if len(movie.tracks) != 1 or len(vids) != 1:
        faults.append(f"{len(movie.tracks)} tracks, {len(vids)} video: "
                      "one video track expected")
    if not vids:
        return faults
    tr = vids[0]
    if tr.codec != "avc1":
        faults.append(f"codec {tr.codec!r}, not avc1")
    if (tr.width, tr.height) != (cfg["width"], cfg["height"]):
        faults.append(f"size {tr.width}x{tr.height}")
    if len(tr.sps) != 1 or len(tr.pps) != 1 or tr.nal_length_size != 4:
        faults.append(f"avcC: {len(tr.sps)} SPS, {len(tr.pps)} PPS, "
                      f"{tr.nal_length_size}-byte lengths")
    if len(tr.sizes) != n_frames:
        faults.append(f"{len(tr.sizes)} samples for {n_frames} frames")
    want = tr.timescale * cfg["fps_den"] / cfg["fps_num"]
    if not tr.timescale or any(d != want for d in tr.durations) \
            or len(tr.durations) != len(tr.sizes):
        faults.append("sample durations are not one frame each")
    sync = tr.sync if tr.sync is not None else list(range(len(tr.sizes)))
    starts = gop_starts(n_frames, cfg["gop"])
    if sync != starts:
        faults.append(f"sync samples {sync[:8]}... are not the GOP starts")
    for i in range(len(tr.sizes)):
        try:
            nals = mp4read.sample_nals(tr, data, i)
        except mp4read.Mp4Error as e:
            faults.append(str(e))
            continue
        types = [n[0] & 31 for n in nals]
        if types != [5 if i in starts else 1]:
            faults.append(f"sample {i}: NAL unit types {types}")
    return faults


def _track(path: str):
    movie, data = mp4read.read(path)
    return next(t for t in movie.tracks if t.handler == "vide"), data


def _job(path: str, frames: list[int], pixels: bool, content: dict,
         width: int, height: int, seed: int) -> list[tuple]:
    """Parse (``pixels`` False) or decode from an IDR (``pixels`` True) the
    given frames of the output: [(frame, error or None, (worst plane MSE,
    {picture number: luma reading}) or None, luma PSNR or None)]. After a failed frame a decode stops: the
    frames that follow it have no reference."""
    from .h264ref.decoder import H264Decoder
    tr, data = _track(path)
    dec = H264Decoder()
    dec.parse_only = not pixels
    src = Content(content, width, height, seed)
    out = []
    for nal in tr.sps + tr.pps:
        dec._decode_nal(nal)
    for k, i in enumerate(frames):
        try:
            n_before = len(dec.frames) + dec.parsed
            for nal in mp4read.sample_nals(tr, data, i):
                dec._decode_nal(nal)
            if len(dec.frames) + dec.parsed != n_before + 1:
                raise ValueError("the sample holds no picture")
        except Exception as e:     # noqa: BLE001 - any failure is a fault
            err = f"frame {i}: {type(e).__name__}: {e}"
            if pixels:
                return out + [(j, err, None, None) for j in frames[k:]]
            out.append((i, err, None, None))
            continue
        if not pixels:
            out.append((i, None, None, None))
            continue
        f = dec.frames[-1]
        pairs = list(zip((f.y, f.u, f.v), src.frame(i)))
        mse = [float(np.mean((a.astype(np.float64) - b) ** 2))
               for a, b in pairs]
        low = {k: lowpass_mse(f.y, pairs[0][1], n)
               for k, n in PICTURES.items()}
        out.append((i, None, (max(mse), low), psnr(mse[0])))
    return out


def lowpass_mse(a: np.ndarray, b: np.ndarray, n: int) -> float:
    """Mean squared error between the means of each n x n block of two
    planes (the blocks that fit)."""
    h, w = (a.shape[0] // n) * n, (a.shape[1] // n) * n

    def means(p):
        return p[:h, :w].astype(np.float64).reshape(
            h // n, n, w // n, n).mean(axis=(1, 3))
    return float(np.mean((means(a) - means(b)) ** 2))


def psnr(mse: float) -> float:
    return 99.0 if mse == 0 else float(10 * np.log10(MSE_MAX / mse))


def compare(outputs: list[str], cfg: dict, traffic: dict, seed: int,
            workers: int | None = None) -> dict:
    """Judge a run's task outputs. Returns ``numbers`` ({name: value} of
    ``NUMBERS``), ``psnr_db`` and ``kbps`` of the sampled output (None
    where it has none), ``faults`` (the first texts) and ``sampled``."""
    n = traffic["loop"]["frames_per_task"]
    if not outputs:
        return {"numbers": dict({"outputs_differ": 0, "container_faults": 0,
                                 "syntax_faults": n},
                                **dict.fromkeys(PICTURES, MSE_MAX)),
                "psnr_db": None, "kbps": None, "faults": [], "sampled": None}
    rng = np.random.default_rng([seed64(seed), _SAMPLE])
    pick = int(rng.integers(len(outputs)))
    with open(outputs[pick], "rb") as fh:
        ref_bytes = fh.read()
    differ = 0
    for p in outputs:
        with open(p, "rb") as fh:
            differ += fh.read() != ref_bytes
    numbers = {"outputs_differ": differ}
    res = {"numbers": numbers, "psnr_db": None, "kbps": None,
           "faults": [], "sampled": pick}
    try:
        movie, data = mp4read.read(outputs[pick])
        faults = container_faults(movie, data, cfg, n)
    except (mp4read.Mp4Error, IndexError, ValueError) as e:
        faults = [f"unreadable MP4: {e}"]
    numbers["container_faults"] = len(faults)
    res["faults"] += faults[:5]
    if faults:
        numbers["syntax_faults"] = n
        numbers.update(dict.fromkeys(PICTURES, MSE_MAX))
        return res
    res["kbps"] = mp4read.video_kbps(movie.tracks[0])
    k = int(traffic["check"]["pixel_frames_per_gop"])
    starts = gop_starts(n, cfg["gop"])
    runs = [list(range(g, min(g + k, n, g + cfg["gop"]))) for g in starts]
    rest = sorted(set(range(n)) - {i for r in runs for i in r})
    args = (traffic["content"], cfg["width"], cfg["height"], seed)
    workers = workers or min(8, os.cpu_count() or 1)
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futs = [pool.submit(_job, outputs[pick], r, True, *args)
                for r in runs]
        futs += [pool.submit(_job, outputs[pick], [i], False, *args)
                 for i in rest]
        rows = [row for f in futs for row in f.result()]
    errs = [e for _, e, _, _ in rows if e]
    mses = [m for _, _, m, _ in rows if m is not None]
    numbers["syntax_faults"] = len(errs)
    end = cfg["gop"] * cfg.get("compared_gops", len(starts))
    whole = len(mses) == sum(len(r) for r in runs)
    for name in PICTURES:
        low = [m[1][name] for i, _, m, _ in rows
               if m is not None and i < end]
        numbers[name] = max(low, default=MSE_MAX) if whole else MSE_MAX
    res["mse_worst"] = max((m[0] for m in mses), default=MSE_MAX)
    lum = [p for _, _, _, p in rows if p is not None]
    res["psnr_db"] = float(np.mean(lum)) if lum else None
    res["faults"] += errs[:5]
    res["frames_decoded"] = len(mses)
    return res


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(correct, lines "name value limit") for every number that the
    cell's ``limits`` name: the four counts and its picture number."""
    lines, ok = [], True
    for name in limits:
        v, lim = numbers[name], limits[name]
        ok &= v <= lim
        lines.append(f"{name} {v} limit {lim}")
    return bool(ok), lines
