"""Kernel launch calls on the host (``cudaLaunchKernel``,
``cuLaunchKernelEx`` and their kin, from the profiler) over the window's
steps."""


def read(w):
    if w.trace is None or not w.trace.launches or not w.steps:
        return None
    return w.trace.launches / len(w.steps)
