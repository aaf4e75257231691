"""The one content generator: source frames from a traffic mix and a seed.

A traffic file's ``content`` names a background and a list of moving
boxes; this module turns them into 4:2:0 frames. Every frame draws its
noise from a generator of its own, seeded by (seed, frame), so any frame
can be made again alone: the comparison re-makes the frames it judges.

Backgrounds:

* ``pan``: a gradient left half and a texture right half that move by
  (``dx``, ``dy``) pixels a frame, so that every 16x16 tile changes
  every frame, plus uniform noise in +-``noise`` drawn anew each frame;
* ``still``: a fixed texture with noise in +-``noise`` drawn once.

Boxes (``size`` x ``size`` luma samples of texture with noise in
+-``noise`` and flat chroma with noise in +-``chroma_noise``) start at
(``x``, ``y``) and move (``dx``, ``dy``) a frame; they are clipped at
the frame's edges.
"""

from __future__ import annotations

import numpy as np

_BG_STILL = 0xB6
_BOX = 0xB0


def seed64(seed: int) -> int:
    """Any whole number as a generator seed (negative ones included)."""
    return int(seed) % (1 << 64)


class Content:
    def __init__(self, spec: dict, width: int, height: int, seed: int):
        self.spec, self.w, self.h = spec, int(width), int(height)
        self.seed = seed64(seed)
        self._still = None
        self._boxes = None

    def _noise(self, rng, n: int, shape) -> np.ndarray:
        return rng.integers(-n, n + 1, shape, dtype=np.int16)

    def _pan(self, t: int, rng):
        bg = self.spec["background"]
        w, h = self.w, self.h
        x = np.arange(w, dtype=np.float32) + np.float32(bg["dx"] * t)
        yv = np.arange(h, dtype=np.float32) + np.float32(bg["dy"] * t)
        grad = (60 + 0.05 * x[None, :] + 0.04 * yv[:, None]
                + 20 * np.sin(x / 67.0)[None, :])
        tex = 128 + 60 * np.sin(x / 2.9)[None, :] * np.cos(yv / 3.7)[:, None]
        left = (np.arange(w) < w // 2)[None, :]
        y = np.where(left, grad, tex) + self._noise(rng, bg["noise"], (h, w))
        cx = np.arange(w // 2, dtype=np.float32)
        cy = np.arange(h // 2, dtype=np.float32)
        u = 128 + 30 * np.sin((cx + np.float32(bg["dx"] / 2 * t)) / 37.0)
        v = 128 + 30 * np.cos((cy + np.float32(bg["dy"] / 2 * t)) / 23.0)
        return [y, np.broadcast_to(u[None, :], (h // 2, w // 2)),
                np.broadcast_to(v[:, None], (h // 2, w // 2))]

    def _still_planes(self):
        if self._still is None:
            bg = self.spec["background"]
            w, h = self.w, self.h
            rng = np.random.default_rng([self.seed, _BG_STILL])
            x = np.arange(w, dtype=np.float32)
            yv = np.arange(h, dtype=np.float32)
            y = (100 + 45 * np.sin(x / 13.0)[None, :]
                 * np.cos(yv / 17.0)[:, None]
                 + self._noise(rng, bg["noise"], (h, w)))
            cx = np.arange(w // 2, dtype=np.float32)
            cy = np.arange(h // 2, dtype=np.float32)
            u = np.broadcast_to((128 + 25 * np.sin(cx / 11.0))[None, :],
                                (h // 2, w // 2))
            v = np.broadcast_to((128 + 25 * np.cos(cy / 9.0))[:, None],
                                (h // 2, w // 2))
            self._still = [_u8(p) for p in (y, u, v)]
        return self._still

    def _box_planes(self):
        if self._boxes is None:
            self._boxes = []
            for k, b in enumerate(self.spec.get("boxes", [])):
                n = int(b["size"])
                rng = np.random.default_rng([self.seed, _BOX + k])
                bx = np.arange(n, dtype=np.float32)
                y = (180 + 50 * np.sin(bx / 5.0)[None, :]
                     * np.cos(bx / 7.0)[:, None]
                     + self._noise(rng, b["noise"], (n, n)))
                u = 90 + self._noise(rng, b["chroma_noise"], (n // 2, n // 2))
                v = 170 + self._noise(rng, b["chroma_noise"], (n // 2, n // 2))
                self._boxes.append([_u8(p) for p in (y, u, v)])
        return self._boxes

    def frame(self, t: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Frame ``t``: (y (H, W), u, v (H/2, W/2)) uint8."""
        kind = self.spec["background"]["kind"]
        if kind == "pan":
            rng = np.random.default_rng([self.seed, int(t)])
            planes = [_u8(p) for p in self._pan(t, rng)]
        elif kind == "still":
            planes = [p.copy() for p in self._still_planes()]
        else:
            raise ValueError(f"unknown background kind {kind!r}")
        for b, box in zip(self.spec.get("boxes", []), self._box_planes()):
            x0 = int(b["x"] + b["dx"] * t)
            y0 = int(b["y"] + b["dy"] * t)
            for k, (p, q) in enumerate(zip(planes, box)):
                d = 2 if k else 1
                _paste(p, q, y0 // d, x0 // d)
        return tuple(planes)


def scaled(spec: dict, factor: float) -> dict:
    """The mix with its boxes' sizes, places and steps scaled by
    ``factor``: the same picture at another frame size (a rehearsal's)."""
    boxes = [dict(b, size=max(8, 2 * round(b["size"] * factor / 2)),
                  **{k: b[k] * factor for k in ("x", "y", "dx", "dy")})
             for b in spec.get("boxes", [])]
    return dict(spec, boxes=boxes)


def _u8(a) -> np.ndarray:
    return np.clip(a, 0, 255).astype(np.uint8)


def _paste(dst: np.ndarray, src: np.ndarray, y0: int, x0: int) -> None:
    h, w = dst.shape
    sy0, sx0 = max(0, -y0), max(0, -x0)
    dy0, dx0 = max(0, y0), max(0, x0)
    dy1 = min(h, y0 + src.shape[0])
    dx1 = min(w, x0 + src.shape[1])
    if dy1 > dy0 and dx1 > dx0:
        dst[dy0:dy1, dx0:dx1] = src[sy0:sy0 + dy1 - dy0,
                                    sx0:sx0 + dx1 - dx0]


def write_y4m(paths_frames: list, content: Content, fps_num: int,
              fps_den: int) -> None:
    """Write the first ``n`` frames of ``content`` to each (path, n) of
    ``paths_frames`` as 4:2:0 Y4M, making each frame once."""
    header = (b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420jpeg\n"
              % (content.w, content.h, fps_num, fps_den))
    fhs = [(open(p, "wb"), n) for p, n in paths_frames]
    try:
        for fh, _ in fhs:
            fh.write(header)
        for t in range(max(n for _, n in paths_frames)):
            data = b"".join(np.ascontiguousarray(p).tobytes()
                            for p in content.frame(t))
            for fh, n in fhs:
                if t < n:
                    fh.write(b"FRAME\n" + data)
    finally:
        for fh, _ in fhs:
            fh.close()
