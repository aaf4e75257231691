"""encoder.p_ms: H264Encoder.stage_s["p"] of the window's GOPs over their
P frames: the P chunks' host dispatch."""


def read(obs):
    gops = obs["gops"]
    n_p = sum(g["frames"] - 1 for g in gops)
    if not n_p:
        return None
    return 1e3 * sum(g["stage_s"]["p"] for g in gops) / n_p
