"""executor.task_overhead_ms: each window task's span (execute and
verify) less its encode_gop spans, averaged over the tasks: Y4M read,
mux, verify and the executor around the GOP coder."""


def read(obs):
    spans = obs["spans"]
    if spans is None:
        return None
    tasks = [t for t in obs["tasks"] if not t.error]
    gops = spans.gops
    over = []
    for t in tasks:
        inside = sum(g["t1"] - g["t0"] for g in gops
                     if t.t0 <= g["t0"] and g["t1"] <= t.t1)
        over.append(t.t1 - t.t0 - inside)
    return 1e3 * sum(over) / len(over) if over else None
