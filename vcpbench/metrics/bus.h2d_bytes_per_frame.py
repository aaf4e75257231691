"""bus.h2d_bytes_per_frame: bytes of the host-to-device copies in the
profiled task's device trace over its frames."""


def read(obs):
    prof = obs["profile"]
    if prof is None or not prof["task"].frames:
        return None
    return prof["h2d_bytes"] / prof["task"].frames
