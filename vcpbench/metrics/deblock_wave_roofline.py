"""deblock_wave_roofline: the least time of the profiled task's deblock
kernel calls (roofline.deblock_fast / deblock_general, from the planes'
shapes and the filtered lines of their bS grids) over the summed time of
the ``deblock_wave`` kernels in its trace, in %."""

from vcpbench import trace


def read(obs):
    prof = obs["profile"]
    if prof is None:
        return None
    least = sum(prof["roofline_s"].get(k, 0.0)
                for k in ("deblock_fast", "deblock_general"))
    spent = trace.kernel_seconds(prof["kernel_s"], "deblock_wave")
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
