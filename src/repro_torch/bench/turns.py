"""Source trees of the port on one card, in turns: what the turns scripts
(``bench/stream_turns.py``, ``bench/gather_scatter_turns.py``) share.

A tree is the root of a checkout of the repo (say a parent commit unpacked
with ``git archive`` into a git-ignored directory, and this tree).  Each
turn runs the calling script again as a worker process that imports
``repro_torch`` from that tree's ``src`` alone (its kernels build into that
tree's ``build/``) and prints one JSON line; :func:`run` prints the card's
``nvidia-smi`` name and power limit, then each turn's line with its turn,
tree, card and seconds.  ``--order`` (default parent, change, change,
parent) names the trees by index, so copies of a tree that differ in one
constant can go in as more trees.

A worker imports only what every tree has: this module stays out of it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Sequence


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def in_tree(script: str, tree: Path, args: Sequence[str],
            timeout: float = 900) -> dict:
    """Runs ``script`` with ``args`` in a fresh process whose
    ``repro_torch`` comes from ``tree``/src; returns its last line, parsed
    as JSON.  ``python -P`` keeps the script's own directory off the path,
    so nothing of this tree's package leaks in."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(tree / "src"), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-P", script, *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"{script} {' '.join(args)} on {tree} failed:\n"
                           f"{proc.stdout}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run(script: str, trees: Sequence[str], order: str,
        worker_args: Callable[[int, Path], List[str]]) -> None:
    """One turn per index of ``order``: ``script`` with
    ``worker_args(turn, tree)`` on ``trees[index]``, each turn's JSON line
    printed as it comes."""
    card = card_line()
    print(card, flush=True)
    for turn, index in enumerate(order):
        tree = Path(trees[int(index)]).resolve()
        t0 = time.perf_counter()
        row = in_tree(script, tree, worker_args(turn, tree))
        row.update(turn=turn, tree=str(tree), card=card,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
