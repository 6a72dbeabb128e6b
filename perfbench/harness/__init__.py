"""The harness's shared parts: finding files by name, the seeded weights,
the profiler's reduction and the printed result."""
