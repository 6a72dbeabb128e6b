"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, for ``sm_90a``, into a shared library with
a plain C interface: ``build/kernels/<name>-<hash>.so`` at the repo root,
where ``<hash>`` covers the source, the shared headers ``csrc/*.cuh`` and
the flags, so a changed source or header rebuilds and an unchanged one is
a cache hit.  Nothing is compiled when a
module is imported: :func:`load` builds at first use, and :func:`build_all`
starts one ``nvcc`` per source at once and returns each compile time and
log (``chip_smoke.py`` prints them).  The log is kept beside the library
(``.log``), so a cache hit still reports it; :func:`ptxas_report` reads
each kernel's registers, shared memory and spills out of it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source,
    every header it may include and the flags)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, dict]:
    """Build every ``csrc/<name>.cu`` of ``names`` whose library is not
    cached, one ``nvcc`` per source, all started together.

    Returns ``{name: {"cache_hit", "seconds", "log"}}``: ``seconds`` from
    the start of the parallel build until that source's ``nvcc`` was
    collected (in the order of ``names``), and ``log`` what ``nvcc``
    printed (``-Xptxas -v``: registers, shared memory, spills).
    Raises ``RuntimeError`` with the compiler output if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[name] = {"cache_hit": True, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        running[name] = (lib, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        out[name] = {"cache_hit": False, "seconds": time.perf_counter() - t0,
                     "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def ptxas_report(log: str) -> List[dict]:
    """Each kernel entry of an ``nvcc -Xptxas -v`` log: ``entry`` (the
    mangled name), ``registers``, ``smem`` (static shared bytes),
    ``stack``, ``spill_stores`` and ``spill_loads`` (bytes), in the log's
    order."""
    out: List[dict] = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            out.append({"entry": entry.group(1)})
            continue
        if not out:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if spill:
            out[-1].update(stack=int(spill.group(1)),
                           spill_stores=int(spill.group(2)),
                           spill_loads=int(spill.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1].update(registers=int(used.group(1)),
                           smem=int(smem.group(1)) if smem else 0)
    return out


def build(name: str) -> dict:
    """Build ``csrc/<name>.cu`` unless its library is already cached (see
    :func:`build_all`)."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
