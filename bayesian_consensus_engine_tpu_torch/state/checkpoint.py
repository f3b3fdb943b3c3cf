"""Snapshot and resume of the device-resident cycle state — the port of
the JAX package's ``state/checkpoint.py``.

The reference's only durable state is its SQLite file, and that stays the
interchange tier (``TensorReliabilityStore.from_sqlite`` /
``flush_to_sqlite``), the format both packages read. On top of it, a
long-running settlement loop snapshots its resident state every N cycles
and resumes it after a preemption without a round trip through strings:

* :class:`CycleCheckpointer` saves any nest of tensors — a
  ``MarketBlockState`` (``exists=None``, the reduced carry, included), a
  grid of per-shard blocks, a ``CompactBlockState``, dicts, tuples and
  lists of them — with a JSON ``meta`` dict, one directory a step.

The JAX package writes orbax checkpoints; the port writes its own: a step
is a directory holding ``state.pt`` (``torch.save`` of the nest with its
tensors on the host, named tuples as dicts of their fields) and
``meta.json``. The card's machine has no JAX and no orbax, so neither
package reads the other's snapshots; the SQLite file is what both read.

A save is atomic (the step is written into a temporary directory and
renamed into place, so a writer killed mid-write leaves no partial step),
keeps the newest ``max_to_keep`` steps, and is asynchronous: the tensors
are copied to host memory on the caller's thread, inside the obs
timeline's ``checkpoint`` span (the part of the save on the loop's
clock), and written and committed on a background thread, which the next
call that reads or writes the directory joins.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from pathlib import Path
from typing import Any, Optional, Union

import torch

from bayesian_consensus_engine_tpu_torch.obs.timeline import active_timeline

STATE_FILE = "state.pt"
META_FILE = "meta.json"
_TMP_PREFIX = ".tmp-"


def _is_namedtuple(value) -> bool:
    return isinstance(value, tuple) and hasattr(value, "_fields")


def _to_host(nest):
    """The nest with every tensor copied to host memory and every named
    tuple as a dict of its fields, for ``torch.save`` (whose
    ``weights_only`` loader takes plain containers only)."""
    if isinstance(nest, torch.Tensor):
        host = nest.detach().to("cpu", copy=True)
        return host.contiguous()
    if _is_namedtuple(nest):
        return {field: _to_host(getattr(nest, field)) for field in nest._fields}
    if isinstance(nest, dict):
        return {key: _to_host(value) for key, value in nest.items()}
    if isinstance(nest, (tuple, list)):
        return type(nest)(_to_host(value) for value in nest)
    if nest is None or isinstance(nest, (bool, int, float, str)):
        return nest
    raise TypeError(f"cannot checkpoint a {type(nest).__name__}")


def _like(saved, like, where: str = "state"):
    """*saved* rebuilt in the structure of *like*: its named tuples, each
    tensor on *like*'s device and in its dtype."""
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: saved a {type(saved).__name__}, "
                             "the template holds a tensor")
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"{where}: saved shape {tuple(saved.shape)}, "
                             f"the template's {tuple(like.shape)}")
        return saved.to(device=like.device, dtype=like.dtype)
    if like is None:
        if saved is not None:
            raise ValueError(f"{where}: saved a value, the template holds None")
        return None
    if _is_namedtuple(like):
        if not isinstance(saved, dict) or set(saved) != set(like._fields):
            raise ValueError(f"{where}: the saved fields are not "
                             f"{type(like).__name__}'s {like._fields}")
        return type(like)(*(
            _like(saved[field], getattr(like, field), f"{where}.{field}")
            for field in like._fields
        ))
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError(f"{where}: the saved keys are not the template's")
        return {key: _like(saved[key], value, f"{where}[{key!r}]")
                for key, value in like.items()}
    if isinstance(like, (tuple, list)):
        if not isinstance(saved, (tuple, list)) or len(saved) != len(like):
            raise ValueError(f"{where}: the saved sequence is not the "
                             "template's length")
        return type(like)(
            _like(value, template, f"{where}[{i}]")
            for i, (value, template) in enumerate(zip(saved, like))
        )
    return saved


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CycleCheckpointer:
    """Snapshot and resume of cycle-state nests, one directory a step.

    Saves any nest of tensors (``MarketBlockState``, grids of per-shard
    blocks, ``CompactBlockState``, dicts, tuples, lists, ``None``) with a
    JSON-serialisable ``meta`` dict. Steps commit atomically and the
    newest ``max_to_keep`` are kept.
    """

    def __init__(self, directory: Union[str, Path], max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep={max_to_keep}: keep at least one step")
        self._directory = Path(directory).resolve()
        self._max_to_keep = int(max_to_keep)
        self._directory.mkdir(parents=True, exist_ok=True)
        # What a killed writer left: never a step (its name is not one).
        for stale in self._directory.glob(_TMP_PREFIX + "*"):
            shutil.rmtree(stale, ignore_errors=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state: Any, meta: Optional[dict] = None,
             force: bool = False) -> bool:
        """Snapshot *state* (with JSON *meta*) as checkpoint *step*.

        The tensors are copied to host memory before this returns (the
        ``checkpoint`` span of the obs timeline), so the caller may go on
        updating them; the files are written and committed on a
        background thread, which the next ``save``, ``wait``,
        ``latest_step``, ``all_steps``, ``restore`` or ``close`` joins
        (raising what the write raised). Returns ``False`` without saving
        when *step* exists already, unless ``force``, which replaces it.
        """
        self.wait()
        step = int(step)
        if step < 0:
            raise ValueError(f"step={step}: steps are non-negative")
        if not force and (self._directory / str(step)).exists():
            return False
        meta_text = json.dumps(meta or {})
        with active_timeline().span("checkpoint"):
            host = _to_host(state)
        self._writer = threading.Thread(
            target=self._commit, args=(step, host, meta_text),
            name=f"checkpoint-{step}", daemon=True,
        )
        self._writer.start()
        return True

    def _commit(self, step: int, host, meta_text: str) -> None:
        try:
            tmp = self._directory / f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex}"
            tmp.mkdir()
            with open(tmp / STATE_FILE, "wb") as handle:
                torch.save(host, handle)
                handle.flush()
                os.fsync(handle.fileno())
            with open(tmp / META_FILE, "w", encoding="utf-8") as handle:
                handle.write(meta_text)
                handle.flush()
                os.fsync(handle.fileno())
            final = self._directory / str(step)
            if final.exists():  # force: the old step goes, then the new comes
                doomed = self._directory / f"{_TMP_PREFIX}old-{uuid.uuid4().hex}"
                os.replace(final, doomed)
                os.replace(tmp, final)
                shutil.rmtree(doomed)
            else:
                os.replace(tmp, final)
            _fsync_dir(self._directory)
            for old in self._steps()[:-self._max_to_keep]:
                shutil.rmtree(self._directory / str(old))
        except Exception as error:  # re-raised on the caller's thread
            self._error = error

    def wait(self) -> None:
        """Block until the save in flight has committed; raise what it
        raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    # -- read ----------------------------------------------------------------

    def _steps(self) -> list:
        return sorted(int(p.name) for p in self._directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        self.wait()
        return self._steps()

    def restore(self, step: Optional[int] = None, like: Any = None
                ) -> tuple[Any, dict]:
        """``(state, meta)`` of checkpoint *step* (default: the latest).

        With ``like`` (a nest of the saved structure, such as the state
        before the preemption) each tensor comes back on the template's
        device and in its dtype, in its named tuples and grids. Without
        it, tensors come back on the CPU as saved, named tuples as dicts
        of their fields. No checkpoint raises ``FileNotFoundError``.
        """
        if step is None:
            step = self.latest_step()
        else:
            self.wait()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._directory}")
        path = self._directory / str(int(step))
        if not path.is_dir():
            raise FileNotFoundError(f"no checkpoint {step} under {self._directory}")
        state = torch.load(path / STATE_FILE, map_location="cpu",
                           weights_only=True)
        with open(path / META_FILE, encoding="utf-8") as handle:
            meta = json.load(handle)
        if like is not None:
            state = _like(state, like)
        return state, meta

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "CycleCheckpointer":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()
