"""Fault-tolerant checkpointing: atomic commit, async writes, restart (port
of ``repro.checkpoint.checkpoint``).

The on-disk layout is the reference's, so the two packages read each
other's files:

  * **atomic commit** — the leaves go to ``step_N.tmp/leaves.npz`` as
    ``leaf_i`` in ``jax.tree.flatten``'s order (:mod:`repro_torch.pytree`),
    then ``manifest.json`` (fsynced), then the directory is renamed to
    ``step_N/`` (the commit point; a crash mid-write leaves only an
    ignorable ``.tmp``);
  * **async writer** — ``save_async`` copies the state to host memory on
    the caller's thread (so a later in-place change of a tensor cannot
    reach the file) and writes on a daemon thread;
  * **retention** — the ``keep_n`` newest checkpoints survive;
  * **restart** — ``latest_step`` + ``restore`` into a template tree.

A bf16 leaf is stored as raw 2-byte records (``|V2``), as ``np.savez``
stores the reference's bf16 arrays, and read back bit for bit.  A float32
LM state interchanges with the reference's in both directions, bit for
bit (the LM parameter trees are the same).  A detector's convolution
weights are OIHW here and HWIO in the reference, so its files belong to
one package each.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time

import numpy as np
import torch

from repro_torch import pytree


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of ``leaf`` as numpy (bf16 as its 2-byte records)."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_host(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    arr = np.require(arr, requirements="C")  # keeps a 0-d leaf 0-d
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 records
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _rmtree(d: pathlib.Path) -> None:
    for p in d.iterdir():
        p.unlink()
    d.rmdir()


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep_n: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- write path ---------------------------------------------------------

    def save(self, step: int, state, mesh_signature: dict | None = None
             ) -> None:
        self._write(step, pytree.tree_map(_to_host, state),
                    mesh_signature or {})

    def save_async(self, step: int, state,
                   mesh_signature: dict | None = None) -> None:
        """Snapshot now, write on a background thread."""
        self.wait()  # one in-flight write at a time
        host_state = pytree.tree_map(_to_host, state)
        self._thread = threading.Thread(
            target=self._write_guarded,
            args=(step, host_state, mesh_signature or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, step, host_state, sig):
        try:
            self._write(step, host_state, sig)
        except Exception as e:  # surfaced by wait()
            self._error = e

    def _write(self, step: int, host_state, sig: dict) -> None:
        leaves, treedef = pytree.flatten(host_state)
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            _rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "leaves.npz",
                 **{f"leaf_{i}": l for i, l in enumerate(leaves)})
        with open(tmp / "manifest.json", "w") as f:
            json.dump({
                "step": step,
                "n_leaves": len(leaves),
                "treedef": str(treedef),
                "mesh": sig,
                "time": time.time(),
                "committed": True,
            }, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            _rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            _rmtree(self.dir / f"step_{s}")

    # -- read path ----------------------------------------------------------

    def steps(self) -> list[int]:
        return sorted(
            int(d.name.split("_")[1]) for d in self.dir.iterdir()
            if d.is_dir() and d.name.startswith("step_")
            and not d.name.endswith(".tmp")
            and (d / "manifest.json").exists())

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def manifest(self, step: int) -> dict:
        with open(self.dir / f"step_{step}" / "manifest.json") as f:
            return json.load(f)

    def restore(self, step: int, like):
        """Restore into the structure of ``like`` (a tree of tensors):
        each leaf in its template's dtype, on its template's device."""
        with np.load(self.dir / f"step_{step}" / "leaves.npz") as data:
            leaves, treedef = pytree.flatten(like)
            if len(leaves) != len(data.files):
                raise ValueError(
                    f"checkpoint has {len(data.files)} leaves, template has "
                    f"{len(leaves)} — incompatible model/optimizer "
                    f"structure")
            restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
        for tpl, arr in zip(leaves, restored):
            if tuple(tpl.shape) != tuple(arr.shape):
                raise ValueError(
                    f"leaf shape mismatch: {tuple(tpl.shape)} vs {arr.shape}")
        return treedef.unflatten([_from_host(a, t)
                                  for a, t in zip(restored, leaves)])
