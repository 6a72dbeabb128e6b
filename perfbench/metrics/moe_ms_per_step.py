"""Device time of the kernels launched inside the MoE feed-forward
(``moe_apply``, in the span the harness puts round it in the traced run),
a step."""


def read(w):
    if w.trace is None or not w.steps:
        return None
    s = w.trace.span_device_s.get("moe", 0.0)
    return 1e3 * s / len(w.steps) if s > 0 else None
