"""95th percentile (nearest rank), over every request submitted in the
traced window whose first prefill lanes the program placed in it, of the
time from its submit to those lanes: the wait for admission and for a
share of the prefill budget.  Read from the program's request marks
(``harness/program.py``)."""
from perfbench.harness import program
from perfbench.harness.stats import nearest_rank


def read(w):
    log = program.log_of(w)
    if log is None:
        return None
    program.note(w, log)
    return nearest_rank([q for q, _ in program.queue_ms(w, log)], 0.95)
