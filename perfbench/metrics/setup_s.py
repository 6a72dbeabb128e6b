"""Set-up: process start to the first instant of the window (imports,
kernel builds, weights, the engine, the KV pool and the ramp)."""


def read(w):
    return w.setup_s
