"""Within-encode parallelism over several devices (``parallel.mesh``)."""
