"""motion_search_roofline: the least time of the profiled task's
motion-search kernel calls (roofline.motion_search, from the calls'
shapes) over the summed time of the ``motion_search`` kernels in its
trace, in %. Nothing to read where no such kernel ran."""

from vcpbench import trace


def read(obs):
    prof = obs["profile"]
    if prof is None:
        return None
    least = prof["roofline_s"].get("motion_search", 0.0)
    spent = trace.kernel_seconds(prof["kernel_s"], "motion_search")
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
