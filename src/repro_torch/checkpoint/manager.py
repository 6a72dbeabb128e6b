"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``):
async npz + manifest, atomic rename, keep-K retention, restore through a
placer.

Layout, the reference's:
    <dir>/step_000000123/
        manifest.json      — step, tree structure, shapes/dtypes
        shard_h<host>.npz  — the leaves, ``leaf_<i>``
    <dir>/LATEST           — atomic pointer (text: step number)

Leaves are numbered in ``jax.tree.flatten``'s order (``repro_torch.tree``:
dict keys sorted, lists and tuples in order, NamedTuple fields in order),
so a checkpoint that either package writes restores in the other.  numpy
has no bfloat16 type without JAX's extension, so a bfloat16 leaf is
stored as float32 and its manifest entry says ``bfloat16``; a bfloat16
leaf that the reference stored (2-byte words) is widened on restore.

``save`` copies every leaf to host memory before it returns (the only
wait for the device), then writes in a background thread; ``wait`` joins
it and raises what the write raised.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf (float32 for bfloat16), never a view."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _from_stored(x: np.ndarray, dtype: str) -> np.ndarray:
    """A stored leaf as numpy can hold it: bfloat16 words widen to
    float32 (the reference stores them as 2-byte words)."""
    if dtype == "bfloat16" and x.dtype.itemsize == 2:
        return (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return x


def _describe(structure) -> str:
    if structure is None:
        return "None"
    if structure == "leaf":
        return "*"
    kind, aux, children = structure
    inner = [_describe(c) for c in children]
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(aux, inner)) + "}"
    if kind == "namedtuple":
        return f"{aux.__name__}({', '.join(inner)})"
    return ("[{}]" if kind == "list" else "({})").format(", ".join(inner))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, host: int = 0):
        self.dir = Path(directory)
        self.keep = keep
        self.host = host
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot to host, then serialize in the background."""
        self.wait()  # one in-flight save at a time
        leaves, structure = tree_lib.flatten(tree)
        host_leaves = [_to_host(x) for x in leaves]      # device->host now
        meta = {
            "step": step,
            "treedef": _describe(structure),
            "leaves": [{"shape": list(x.shape), "dtype": _dtype_name(leaf)}
                       for x, leaf in zip(host_leaves, leaves)],
            "time": time.time(),
        }

        def write():
            try:
                tmp = self.dir / f".tmp_step_{step:09d}_h{self.host}"
                final = self.dir / f"step_{step:09d}"
                tmp.mkdir(parents=True, exist_ok=True)
                np.savez(tmp / f"shard_h{self.host}.npz",
                         **{f"leaf_{i}": x for i, x in enumerate(host_leaves)})
                (tmp / "manifest.json").write_text(json.dumps(meta))
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)                 # atomic publish
                latest_tmp = self.dir / ".LATEST.tmp"
                latest_tmp.write_text(str(step))
                os.replace(latest_tmp, self.dir / "LATEST")
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}") from err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if f.exists():
            try:
                s = int(f.read_text().strip())
                if (self.dir / f"step_{s:09d}").exists():
                    return s
            except ValueError:
                pass
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                placer: Optional[Callable[[np.ndarray, Any], Any]] = None
                ) -> Any:
        """Rebuild a ``like``-structured tree from disk.

        ``placer(host_array, like_leaf)`` places each leaf (the trainer's
        puts it on the device and in the dtype of ``like_leaf``); without
        one the leaves come back as numpy arrays.
        """
        d = self.dir / f"step_{step:09d}"
        dtypes = [leaf["dtype"] for leaf in
                  json.loads((d / "manifest.json").read_text())["leaves"]]
        leaves_like, structure = tree_lib.flatten(like)
        if len(dtypes) != len(leaves_like):
            raise ValueError(f"step {step} holds {len(dtypes)} leaves, the "
                             f"tree to restore {len(leaves_like)}")
        restored = []
        with np.load(d / f"shard_h{self.host}.npz") as data:
            for i, leaf in enumerate(leaves_like):
                x = _from_stored(data[f"leaf_{i}"], dtypes[i])
                if tuple(x.shape) != tuple(leaf.shape):
                    raise ValueError(f"leaf {i}: stored shape {x.shape}, "
                                     f"expected {tuple(leaf.shape)}")
                restored.append(placer(x, leaf) if placer is not None
                                else x)
        return tree_lib.unflatten(structure, restored)
