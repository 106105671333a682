"""Checkpointing: atomic, async.

Port of ``repro.checkpoint.ckpt`` without its mesh and reshard-on-load
(the parallel slice).  Layout of one checkpoint, as in JAX:

    <dir>/step_<N>/
        manifest.json     — step, flat key list, shapes/dtypes, extra
        arrays.npz        — one entry per flat key (copied to the host)
        _COMMITTED        — written last; a checkpoint without it is
                            ignored (atomic-commit marker)

A tree is nested dicts, lists and tuples of tensors and Python ints (the
step counters); a key joins the path with ``||``.  npz has no bfloat16, so
bf16 leaves are stored as their raw 16-bit words and the manifest's dtype
restores the view on load.  Async mode copies the state to the host, then
writes it in a background thread while training goes on.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, tree_map

_SEP = "||"


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _host(state: Any) -> Any:
    """A copy of ``state`` on the host: tensors on the CPU, ints as they
    are."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, state)


def save(ckpt_dir: str | Path, step: int, state: Any,
         extra: dict | None = None) -> Path:
    """Synchronous atomic save."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = {_key(path): leaf for path, leaf in leaves_with_path(state)}
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    manifest = {
        "step": int(step),
        "time": time.time(),
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        "extra": extra or {},
    }
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    (tmp / "_COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


class AsyncCheckpointer:
    """Snapshot to host synchronously, write to disk in the background."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3) -> None:
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: BaseException | None = None

    def save(self, step: int, state: Any, extra: dict | None = None) -> None:
        self.wait()
        host_state = _host(state)   # device -> host now

        def work():
            try:
                save(self.ckpt_dir, step, host_state, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(committed_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:08d}",
                          ignore_errors=True)


def committed_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for d in ckpt_dir.glob("step_*"):
        if (d / "_COMMITTED").exists():
            out.append(int(d.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, template: Any,
            step: int | None = None) -> tuple[Any, dict]:
    """Load into the structure of ``template``: each tensor leaf takes the
    template leaf's dtype and device, each int leaf stays an int."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as arrays:
        keys = {_key(path) for path, _ in leaves_with_path(template)}
        missing = keys - set(arrays.files)
        extra_keys = set(arrays.files) - keys
        if missing or extra_keys:
            raise ValueError(f"checkpoint/template mismatch: "
                             f"missing={sorted(missing)[:4]} "
                             f"extra={sorted(extra_keys)[:4]}")
        loaded = {k: arrays[k] for k in keys}

    paths = iter(path for path, _ in leaves_with_path(template))

    def load(leaf):
        key = _key(next(paths))
        arr = loaded[key]
        if not isinstance(leaf, torch.Tensor):
            return type(leaf)(arr)
        if manifest["dtypes"].get(key) == "bfloat16":   # raw 16-bit words
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return tree_map(load, template), manifest
