"""B1's share of its roofline: the least time of the window's calls of the
ragged paged-attention kernel (the configuration's counts, ``w.counts``;
by default ``counts.b1`` in every layer, from the lanes each request ran),
over the device time of its kernels (``ragged_attention_kernel`` and
``entry_lists_kernel``), in percent."""
KERNELS = ("ragged_attention_kernel", "entry_lists_kernel")


def read(w):
    if w.trace is None:
        return None
    device_s = sum(v for k, v in w.trace.device_s_by_kernel.items()
                   if any(name in k for name in KERNELS))
    if device_s <= 0:
        return None
    bound, by = 0.0, set()
    for s in w.steps:
        t, b = w.counts.b1_step_bound_s(w.dims, s.lanes, w.block_size)
        bound += t
        by.add(b)
    w.notes["b1_roofline bound"] = "/".join(sorted(by))
    return 100.0 * bound / device_s
