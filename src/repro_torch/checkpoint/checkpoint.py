"""Checkpoints that do not depend on the process group, written in the
background and published atomically.

Layout:  <dir>/step_<n>/arrays.npz + manifest.json  (+ <dir>/LATEST),
the JAX package's layout, so either package reads the other's files.

- State is a nested dict (or list) of tensors, stored as whole host
  arrays: a restore onto another number of ranks is a plain re-slice.
  bf16/fp8 tensors are stored as float32 and cast back on restore.
- Writes run on a background thread; ``wait()`` drains the queue.  A step
  directory is renamed into place only after its write succeeded, so a
  crash mid-write never corrupts LATEST.  ``keep`` bounds how many
  checkpoints are retained.
- An error of the background writer is raised by the next ``wait()`` or
  ``save()``, once; a synchronous write raises at once.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict/list/tuple, in order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    """A host numpy copy; dtypes numpy lacks (bf16, fp8) go as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype.is_floating_point and t.dtype not in (
                torch.float16, torch.float32, torch.float64):
            t = t.float()
        return t.numpy().copy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _unflatten_like(template, flat: Dict[str, np.ndarray], device,
                    prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, device, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, device, prefix + (str(i),))
            for i, v in enumerate(template))
    arr = flat["/".join(prefix)]
    if isinstance(template, torch.Tensor):
        dev = template.device if device is None else torch.device(device)
        return torch.from_numpy(np.array(arr)).to(device=dev,
                                                  dtype=template.dtype)
    if hasattr(template, "dtype") and arr.dtype != template.dtype:
        arr = arr.astype(template.dtype)
    return arr


class CheckpointManager:
    """Saves and restores nested tensor state under ``directory``.

    ``keep`` checkpoints are retained; ``async_write`` writes on a
    background thread.
    """

    def __init__(self, directory, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None):
        """Copy ``state`` to the host now and write it (in the background
        with ``async_write``); ``extra`` goes into the manifest."""
        # a failed background write is raised here rather than lost
        self._raise_pending()
        flat = _flatten(state)
        if self.async_write:
            self._q.put((step, flat, extra or {}))
        else:
            self._write(step, flat, extra or {})

    def wait(self):
        """Block until every queued write is done; raise a writer error."""
        if self.async_write:
            self._q.join()
        self._raise_pending()

    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if not f.exists():
            return None
        return int(f.read_text().strip())

    def restore(self, template, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure and dtypes of ``template``.

        Tensors land on ``device`` (None: each template tensor's device);
        returns ``(state, manifest)``.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        manifest = json.loads((d / "manifest.json").read_text())
        return _unflatten_like(template, flat, device), manifest

    def _raise_pending(self):
        """Re-raise (once) an exception the background writer caught."""
        err, self._err = self._err, None
        if err is not None:
            raise err

    def _worker(self):
        while True:
            step, flat, extra = self._q.get()
            try:
                self._write(step, flat, extra)
            except BaseException as e:  # raised on the next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra: Dict[str, Any]):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}_{os.getpid()}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {"step": step, "time": time.time(),
                    "n_arrays": len(flat),
                    "bytes": int(sum(a.nbytes for a in flat.values())),
                    **extra}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                              # atomic publish
        (self.dir / "LATEST").write_text(str(step))
        self._gc()

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
