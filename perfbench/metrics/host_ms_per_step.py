"""Host time of the serving loop a step: the engine's own phase timers
``propose``, ``schedule_render`` and ``commit`` (host clock, its
``phase_s``), summed over the window's steps, over the step count."""

PHASES = ("propose", "schedule_render", "commit")


def read(w):
    if not w.steps:
        return None
    return 1e3 * sum(w.phase_s.get(k, 0.0) for k in PHASES) / len(w.steps)
