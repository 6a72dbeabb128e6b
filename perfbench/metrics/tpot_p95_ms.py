"""95th percentile (nearest rank), over every request completed in the
window with two or more output tokens, of (last token - first token) /
(tokens - 1)."""
from perfbench.harness.stats import nearest_rank


def read(w):
    ms = [1e3 * (r.done - r.first) / (r.emitted - 1) for r in w.records
          if w.inside(r.done) and r.emitted >= 2]
    w.notes["tpot_p95_ms samples"] = len(ms)
    return nearest_rank(ms, 0.95)
