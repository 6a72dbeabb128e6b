"""95th percentile (nearest rank), over every request whose first token
came in the window, of the time from its client's send to that token."""
from perfbench.harness.stats import nearest_rank


def read(w):
    ms = [1e3 * (r.first - r.sent) for r in w.records if w.inside(r.first)]
    w.notes["ttft_p95_ms samples"] = len(ms)
    return nearest_rank(ms, 0.95)
