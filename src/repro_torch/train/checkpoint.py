"""Checkpointing: one .npy file a leaf and a JSON manifest, atomic,
asynchronous, keep-last-k.

The PyTorch counterpart of ``repro.train.checkpoint``, with its layout:

    <dir>/step_<n>/
        manifest.json      {"step": n, "leaves": [{"path", "shape", "dtype"}]}
        leaf_00000.npy ...

Leaves are numbered in the order in which ``jax.tree_util`` flattens a
tree: dict keys sorted, tuples and NamedTuples (the optimizer states) in
field order, None holding nothing.  So a checkpoint written by either
package restores in the other.

  * atomic publish: written into ``.tmp-step_<n>`` and renamed, so a
    killed writer never leaves a half checkpoint that restore would trust;
  * asynchronous: ``save`` copies the leaves to the host in the caller,
    a worker thread writes the files; ``wait()`` drains it;
  * keep-last-k: older step directories are pruned after a publish;
  * ``restore`` takes a template tree (structure and shapes) and refuses
    a leaf count or a shape that differs.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any) -> list:
    """The leaves of ``tree`` in jax's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in flatten order."""
    if template is None:
        return None
    if isinstance(template, dict):
        filled = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(t, leaves) for t in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(t, leaves) for t in template)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, taken now."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_writes: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue | None = None
        self._err: list[Exception] = []
        if async_writes:
            self._q = queue.Queue(maxsize=2)
            threading.Thread(target=self._drain, daemon=True).start()

    # -- public ---------------------------------------------------------

    def save(self, step: int, tree: Any) -> None:
        """Snapshot ``tree`` (a host copy taken now) and persist it."""
        if self._err:
            raise self._err.pop()
        host = [_host(leaf) for leaf in _flatten(tree)]
        if self._q is not None:
            self._q.put((step, host))
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._q is not None:
            self._q.join()
        if self._err:
            raise self._err.pop()

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, template: Any, *, step: int | None = None) -> Any:
        """Load a checkpoint (the latest by default) into the structure of
        ``template``.  A tensor leaf comes back as a tensor on the
        template leaf's device, with the file's dtype; a Python scalar
        leaf as a Python scalar."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        t_leaves = _flatten(template)
        if len(manifest["leaves"]) != len(t_leaves):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, template "
                f"has {len(t_leaves)}: structure mismatch")
        out = []
        for meta, tmpl in zip(manifest["leaves"], t_leaves):
            arr = np.load(os.path.join(d, meta["path"]))
            tshape = getattr(tmpl, "shape", None)
            if tshape is None:                  # Python scalar leaf
                out.append(arr.item() if arr.ndim == 0 else arr)
                continue
            if tuple(arr.shape) != tuple(tshape):
                raise ValueError(
                    f"leaf {meta['path']}: shape {arr.shape} != template "
                    f"{tuple(tshape)}")
            if isinstance(tmpl, torch.Tensor):
                out.append(torch.from_numpy(arr).to(tmpl.device))
            else:
                out.append(arr)
        return _unflatten(template, iter(out))

    # -- internals --------------------------------------------------------

    def _drain(self):
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except Exception as e:           # raised by the next save/wait
                self._err.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, host: list[np.ndarray]) -> None:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = os.path.join(self.dir, f".tmp-step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        metas = []
        for i, arr in enumerate(host):
            path = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, path), arr)
            metas.append({"path": path, "shape": list(arr.shape),
                          "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": metas}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                # atomic publish
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
