"""Model FLOPs of the lanes served in the traced window (the configuration's
counts, ``w.counts``; by default ``counts.flops``: routed top-k experts,
causal attention over each lane's real keys, the head for the rows that
sampled) over the window's seconds times the card's bf16 peak, in
percent."""
from perfbench.counts import peaks


def read(w):
    if w.trace is None or not w.steps:
        return None
    total = sum(w.counts.step_flops(w.dims, s.lanes, s.sampled)
                for s in w.steps)
    return 100.0 * total / (w.seconds * peaks.BF16_FLOPS)
