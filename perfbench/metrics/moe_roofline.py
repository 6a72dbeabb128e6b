"""The MoE layers' share of their roofline: the least time of the routed
work the window's lanes need (the configuration's counts, ``w.counts``;
by default ``counts.moe``), over the device time of the kernels launched
inside ``moe_apply``, in percent."""


def read(w):
    if w.trace is None or not w.dims.moe:
        return None
    device_s = w.trace.span_device_s.get("moe", 0.0)
    if device_s <= 0:
        return None
    bound, by = 0.0, set()
    for s in w.steps:
        tokens = sum(n for n, _ in s.lanes)
        t, b = w.counts.moe_step_bound_s(w.dims, tokens)
        bound += t
        by.add(b)
    w.notes["moe_roofline bound"] = "/".join(sorted(by))
    return 100.0 * bound / device_s
