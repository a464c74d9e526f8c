"""Checkpointing: atomic, asynchronous, resume-exact (counterpart of
``repro.checkpoint.checkpointer``, with the same layout on disk).

Layout (one step):
  <dir>/step_000000123.tmp/        written first
      host_0.npz                   the tree's leaves, one array per key
      manifest.json                keys, shapes, dtypes, step (+ sim fields)
  <dir>/step_000000123/            atomic rename on completion (the commit)

Leaf keys are the reference's (``jax.tree_util`` paths joined by ``/``):
a NamedTuple field gives its name, a dict key itself (dicts flatten in
sorted key order), a list or tuple entry its index; ``None`` holds no leaf.
So an ``EngineState`` saves ``world/<field>``, ``pool/<field>`` and the
top-level leaves, and a checkpoint written by either package, on the card or
on the CPU, restores in the other. Tensors leave through
``.detach().cpu()`` and return on the engine's device.

:class:`SimCheckpointer` saves the whole engine state at a window boundary
with the attached streams' drained trace spans and metrics records. Its saves
block, and the rename is the commit point, so a SIGKILL at any instant leaves
either the previous checkpoint or the new one.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.convert import _t


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's flattening order."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    return [p for k, v in items for p in _tree_paths(v, join(k))]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(arr: np.ndarray, proto):
    """``arr`` as a leaf like ``proto``: a tensor of its dtype on its
    device, or a numpy array of its dtype."""
    if isinstance(proto, torch.Tensor):
        return _t(arr, proto.device).to(proto.dtype)
    if hasattr(proto, "dtype"):
        return np.asarray(arr, dtype=proto.dtype)
    return arr


def tree_keys(tree) -> list[str]:
    """The leaf keys a tree saves under (the checkpoint layout)."""
    return [k for k, _leaf in _tree_paths(tree)]


class Checkpointer:
    """Atomic tree checkpoints in ``directory``, the newest ``keep``
    retained; ``save`` writes on a background thread unless ``blocking``."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def _write_step(self, step: int, arrays: dict[str, np.ndarray],
                    manifest: dict, *, host: int = 0,
                    blocking: bool = False) -> None:
        """Commit one step: write a tmp dir, then rename it."""
        self.wait()

        def write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"host_{host}.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # commit point
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def save(self, step: int, tree, *, host: int = 0, blocking: bool = False):
        arrays = {k: _numpy(v) for k, v in _tree_paths(tree)}
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        }
        self._write_step(step, arrays, manifest, host=host, blocking=blocking)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_step(self, step: int | None, *, host: int = 0):
        """(step, npz blob, manifest) of a committed step (default the
        latest)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        blob = np.load(os.path.join(path, f"host_{host}.npz"))
        return step, blob, manifest

    def restore(self, tree_like, step: int | None = None, *, host: int = 0):
        """Restore into the structure and dtypes of ``tree_like``. Returns
        (step, tree)."""
        step, blob, manifest = self._read_step(step, host=host)
        keyed = _tree_paths(tree_like)
        want = {k for k, _ in keyed}
        have = set(manifest["keys"])
        if want != have:
            raise ValueError(
                f"checkpoint structure mismatch: missing {sorted(want - have)[:5]} "
                f"unexpected {sorted(have - want)[:5]}")
        leaves = [_like(blob[k], proto) for k, proto in keyed]
        return step, _unflatten(tree_like, iter(leaves))


# ------------------------------------------------------------ engine layer
_STATE = "state/"        # EngineState leaves
_TRACE_SEG = "trace_seg/"  # drained TraceStream spans: trace_seg/<agent>/<start>
_METRICS = "metrics/"    # MetricsStream interval records: metrics/lines


class SimCheckpoint(NamedTuple):
    """One restored simulation checkpoint: pass ``state`` to a driver's
    ``state=`` and ``rung`` (the adaptive rung chosen for the next window at
    save time; None for the static driver) to ``run_adaptive``'s
    ``rung=``."""

    step: int
    state: Any
    rung: int | None


class SimCheckpointer(Checkpointer):
    """Engine checkpoints at window boundaries.

    Attached to an engine (``checkpointer=``), it is handed the state every
    ``every`` windows (with the adaptive rung, if any). Saves block: the
    window boundary is the one point where the device state, the drained
    trace spans and the rung agree.

    ``kill_after`` is the crash harness: SIGKILL this process right after
    the first committed checkpoint at a window >= ``kill_after``.
    """

    def __init__(self, directory: str, every: int = 0, keep: int = 3,
                 kill_after: int | None = None):
        super().__init__(directory, keep=keep)
        if every < 0:
            raise ValueError(f"every must be >= 0, got {every}")
        self.every = int(every)
        self.kill_after = kill_after

    def due(self, window: int) -> bool:
        """Does the cadence call for a save at this window boundary?"""
        return self.every > 0 and window > 0 and window % self.every == 0

    # ------------------------------------------------------------------ save
    def save_sim(self, window: int, state, *, engine=None,
                 rung: int | None = None) -> None:
        """Save one window-boundary snapshot (blocking, atomic). With
        ``engine`` given, its trace stream's drained spans and its metrics
        stream's records are saved beside the state."""
        arrays = {_STATE + k: _numpy(v) for k, v in _tree_paths(state)}
        ts = getattr(engine, "trace_stream", None)
        ms = getattr(engine, "metrics_stream", None)
        if ts is not None:
            for k, rows in ts.state_dict().items():
                arrays[_TRACE_SEG + k] = rows
        if ms is not None:
            for k, rows in ms.state_dict().items():
                arrays[_METRICS + k] = rows
        manifest = {
            "step": window,
            "sim": True,
            "rung": rung,
            "n_agents": int(state.t_now.shape[0]),
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        }
        self._write_step(window, arrays, manifest, blocking=True)
        if self.kill_after is not None and window >= int(self.kill_after):
            os.kill(os.getpid(), signal.SIGKILL)  # the crash harness

    # --------------------------------------------------------------- restore
    def restore_sim(self, engine, step: int | None = None) -> SimCheckpoint:
        """Restore a checkpoint into ``engine``'s state structure.

        Every leaf is checked against ``engine.init_state()`` (the same
        scenario gives the same shapes) and lands on the engine's device;
        the saved trace spans and metrics records are staged in the
        engine's streams for their next ``begin()``."""
        step, blob, manifest = self._read_step(step)
        template = engine.init_state()
        keyed = _tree_paths(template)
        want = {_STATE + k for k, _ in keyed}
        have = {k for k in manifest["keys"] if k.startswith(_STATE)}
        if want != have:
            raise ValueError(
                f"checkpoint does not match this engine's EngineState: "
                f"missing {sorted(want - have)[:5]} "
                f"unexpected {sorted(have - want)[:5]}")
        leaves = []
        for k, proto in keyed:
            arr = blob[_STATE + k]
            if tuple(arr.shape) != tuple(proto.shape):
                raise ValueError(
                    f"checkpoint leaf {k!r} has shape {arr.shape}, engine "
                    f"expects {tuple(proto.shape)} — same scenario spec "
                    f"(n_agents, pool_cap, trace_cap) required to resume")
            leaves.append(_like(arr, proto))
        state = _unflatten(template, iter(leaves))
        segs = {k[len(_TRACE_SEG):]: np.asarray(blob[k])
                for k in manifest["keys"] if k.startswith(_TRACE_SEG)}
        ts = getattr(engine, "trace_stream", None)
        if ts is not None and segs:
            ts.load_state(segs)
        recs = {k[len(_METRICS):]: np.asarray(blob[k])
                for k in manifest["keys"] if k.startswith(_METRICS)}
        ms = getattr(engine, "metrics_stream", None)
        if ms is not None and recs:
            ms.load_state(recs)
        rung = manifest.get("rung")
        return SimCheckpoint(step=step, state=state,
                             rung=None if rung is None else int(rung))
