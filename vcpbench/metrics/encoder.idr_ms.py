"""encoder.idr_ms: H264Encoder.stage_s["idr"] of the window's GOPs over
their IDRs (one a GOP): the IDR's host dispatch."""


def read(obs):
    gops = obs["gops"]
    if not gops:
        return None
    return 1e3 * sum(g["stage_s"]["idr"] for g in gops) / len(gops)
