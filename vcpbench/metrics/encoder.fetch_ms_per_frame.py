"""encoder.fetch_ms_per_frame: H264Encoder.stage_s["fetch"] of the
window's GOPs over their frames: the host waiting on device-to-host
copies, which wait for the device."""


def read(obs):
    gops = obs["gops"]
    n = sum(g["frames"] for g in gops)
    if not n:
        return None
    return 1e3 * sum(g["stage_s"]["fetch"] for g in gops) / n
