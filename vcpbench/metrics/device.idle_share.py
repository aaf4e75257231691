"""device.idle_share: the share of the profiled task's window (between
the sentinel copies) in which no kernel or copy ran on the card, in %."""


def read(obs):
    prof = obs["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
