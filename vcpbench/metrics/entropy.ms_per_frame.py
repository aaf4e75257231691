"""entropy.ms_per_frame: H264Encoder.stage_s["entropy"] of the window's
GOPs over their frames: unpacking and the host CABAC slice writers."""


def read(obs):
    gops = obs["gops"]
    n = sum(g["frames"] for g in gops)
    if not n:
        return None
    return 1e3 * sum(g["stage_s"]["entropy"] for g in gops) / n
