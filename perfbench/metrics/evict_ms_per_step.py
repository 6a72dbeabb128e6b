"""Host time of the KV allocator's evictions a step: the program's
``kv.evict`` total (``BlockAllocator._pop_block`` taking a cached-free
block, the eviction policy's choice included) over the window's steps.
Read from the program's own span log (``harness/program.py``)."""
from perfbench.harness import program


def read(w):
    log = program.log_of(w)
    if log is None:
        return None
    program.note(w, log)
    return 1e-6 * log.ns.get("kv.evict", 0) / len(w.steps)
