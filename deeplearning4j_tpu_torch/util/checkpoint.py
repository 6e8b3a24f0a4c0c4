"""Sharded training checkpoints, keep-N, and checkpoint-restart training
(counterpart of deeplearning4j_tpu/util/checkpoint.py).

The reference stores its state through Orbax; the port keeps the same
directory layout, sidecar and contract with npz members in Orbax's place:
``<dir>/<step>/state.npz`` holds params, states, optimizer states and the
counters (one file by :func:`save_tree_npz`), ``<dir>/<step>/
elastic_meta.json`` the sidecar. So a sharded checkpoint is read only by
the package that wrote it; the ModelSerializer archive
(``util/model_serializer.py``) is the interchange between the packages.

The contract:

- **Atomic commit**: a save writes ``<dir>/.tmp-<step>-<pid>`` and renames
  it to ``<dir>/<step>`` once the whole state and the sidecar are on disk;
  a crash mid-save leaves only the ``.tmp-*`` directory, which listing
  ignores and the next save sweeps.
- **Corruption-tolerant restore**: :meth:`ShardedCheckpointer.
  restore_latest_good` walks the steps newest first and skips (counts, and
  renames aside) one that fails to load.
- **Full resume state**: the iteration, the epoch and the dropout
  generator's state ride with the arrays, so a resumed ``fit`` draws the
  same streams as an uninterrupted one.
- **Retried I/O** under a small :class:`RetryPolicy` (the part of the
  reference's ``util/faults.py`` this module uses; the full policy is in
  the port's ``util/faults.py``).
- **Gradient-compression sidecar**: a model fitted by a compressed
  ``ParallelWrapper`` carries ``_grad_comp_state`` (the error-feedback
  residual and the threshold); it is saved as ``<step>/grad_comp.npz``
  inside the same atomic commit, and a restore without it clears a live
  state (reference ``:221-225``, ``:388-397``).
- **Async save**: ``save(..., block=False)`` copies the state to the host
  on the caller's thread and commits on a background thread;
  :meth:`ShardedCheckpointer.wait_until_finished` joins it.

Telemetry (the reference's names): ``elastic.checkpoint_commit`` and
``elastic.checkpoint_restore`` spans, the ``elastic.checkpoints_total``,
``elastic.checkpoint_errors_total``, ``elastic.commit_hook_errors_total``
and ``checkpoint.corrupt_skipped_total`` counters, the
``elastic.last_checkpoint_step`` gauge and a ``checkpoint.corrupt_skipped``
instant. Each checkpointer also keeps its own counts as attributes of the
same names, for callers that hold it. :class:`FaultTolerantTrainer` writes
``CrashReportingUtil``'s dump (``util/stats.py``) on each failure.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.util import telemetry as tm
from deeplearning4j_tpu_torch.util.model_serializer import (_host_tree,
                                                            fingerprint,
                                                            jax_items)

_META_FILE = "elastic_meta.json"
_STATE_FILE = "state.npz"
_COMP_FILE = "grad_comp.npz"
_TMP_PREFIX = ".tmp-"


def _tree_spec(tree, arrays: list):
    """JSON-able spec of a dict/list/tuple/None tree with array leaves;
    leaves go to ``arrays`` and are referenced by index."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        return {"t": "dict", "items": [[k, _tree_spec(v, arrays)]
                                       for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "items": [_tree_spec(v, arrays) for v in tree]}
    arrays.append(np.asarray(tree))
    return {"t": "arr", "i": len(arrays) - 1}


def _tree_unspec(spec, arrays):
    if spec["t"] == "none":
        return None
    if spec["t"] == "dict":
        return {k: _tree_unspec(v, arrays) for k, v in spec["items"]}
    if spec["t"] in ("list", "tuple"):
        items = [_tree_unspec(v, arrays) for v in spec["items"]]
        return items if spec["t"] == "list" else tuple(items)
    return arrays[spec["i"]]


def save_tree_npz(path: str, tree) -> None:
    """One npz file holding a dict/list-structured tree of arrays."""
    arrays: list = []
    spec = _tree_spec(tree, arrays)
    np.savez(path, __spec__=np.frombuffer(json.dumps(spec).encode(),
                                          dtype=np.uint8),
             **{f"a{i}": a for i, a in enumerate(arrays)})


def load_tree_npz(path: str):
    with np.load(path) as z:
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode())
        arrays = {int(k[1:]): z[k] for k in z.files if k != "__spec__"}
    return _tree_unspec(spec, [arrays[i] for i in range(len(arrays))])


class RetryExhaustedError(RuntimeError):
    """A retried operation failed on every attempt (``__cause__`` is the
    last failure)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter and an overall deadline (the run
    loop of the reference's ``util/faults.py`` RetryPolicy)."""

    max_attempts: int = 3
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 5.0
    jitter: float = 0.25
    deadline: Optional[float] = None

    def run(self, fn: Callable, *, name: str = "op",
            retry_on: tuple = (Exception,)):
        t0 = time.monotonic()
        delay, last = self.base_delay, None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retry_on as e:  # noqa: PERF203 - a retry loop
                last = e
                if attempt >= self.max_attempts - 1:
                    break
                d = min(delay, self.max_delay) * (
                    1.0 - self.jitter * random.random())
                if (self.deadline is not None
                        and time.monotonic() - t0 + d > self.deadline):
                    break
                time.sleep(d)
                delay *= self.multiplier
        raise RetryExhaustedError(
            f"{name}: failed after {self.max_attempts} attempts "
            f"({type(last).__name__}: {last})") from last


#: checkpoint I/O default: a couple of quick retries, bounded overall
_IO_RETRY = RetryPolicy(max_attempts=3, base_delay=0.2, max_delay=2.0,
                        deadline=60.0)


def _fill(name: str, dst, src) -> None:
    """Copy the loaded tree ``src`` into the model's tree ``dst`` in place;
    the structures and shapes must match."""
    if fingerprint(dst) != fingerprint(src):
        raise ValueError(f"checkpoint {name} structure {fingerprint(src)} "
                         f"does not match the model's {fingerprint(dst)}")
    with torch.no_grad():
        for (path, d), (_, s) in zip(jax_items(dst), jax_items(src)):
            s = np.asarray(s)
            if tuple(s.shape) != tuple(d.shape):
                raise ValueError(f"checkpoint {name} {list(path)}: shape "
                                 f"{s.shape} != {tuple(d.shape)}")
            d.copy_(torch.from_numpy(np.ascontiguousarray(s)))


class ShardedCheckpointer:
    """Keep-N checkpoints of a network's training state."""

    def __init__(self, directory: str, keep: int = 3,
                 retry: Optional[RetryPolicy] = _IO_RETRY, log_fn=print):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.retry = retry
        self.log = log_fn
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        #: steps this instance committed (the same-step fast path)
        self._committed_steps: set = set()
        self._commit_hooks: list = []
        self.checkpoints_total = 0
        self.checkpoint_errors_total = 0
        self.commit_hook_errors_total = 0
        self.corrupt_skipped_total = 0
        self.last_checkpoint_step: Optional[int] = None

    def add_commit_hook(self, hook) -> None:
        """``hook(step)`` after every commit, on the committing thread; a
        failing hook is counted and logged, never raised."""
        if hook not in self._commit_hooks:
            self._commit_hooks.append(hook)

    # ------------------------------------------------------------------ save
    @staticmethod
    def _state(model) -> dict:
        gen = getattr(model, "_gen", None)
        meta = {"iteration": np.asarray(model.iteration),
                "epoch": np.asarray(model.epoch)}
        if gen is not None:
            meta["torch_generator"] = gen.get_state().numpy()
            meta["torch_generator_device"] = np.frombuffer(
                gen.device.type.encode(), dtype=np.uint8).copy()
        return {"params": _host_tree(model.params),
                "states": _host_tree(model.states),
                "opt_states": _host_tree(model.opt_states), "meta": meta}

    def _commit(self, step: int, state: dict,
                extra_meta: Optional[dict], comp_state=None) -> None:
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}-{os.getpid()}")
        final = os.path.join(self.directory, str(step))

        def write_meta(directory):
            # the epoch rides the sidecar: two saves of one step at an
            # epoch's end differ only there, and the fast path below
            # refreshes only this file
            meta_tmp = os.path.join(directory, f"{_META_FILE}.tmp")
            with open(meta_tmp, "w") as f:
                json.dump({"step": step,
                           "epoch": int(state["meta"]["epoch"]),
                           **(extra_meta or {})}, f)
            os.replace(meta_tmp, os.path.join(directory, _META_FILE))

        def attempt():
            if os.path.isdir(final) and step in self._committed_steps:
                # this run's own step again: the arrays are already right
                write_meta(final)
                return
            if os.path.isdir(final):
                # a foreign checkpoint at this step: moved aside, not kept
                os.replace(final, os.path.join(
                    self.directory,
                    f".replaced-{step}-{os.getpid()}-{int(time.time())}"))
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            save_tree_npz(os.path.join(tmp, _STATE_FILE), state)
            if comp_state is not None:
                # the gradient-compression sidecar (parallel/compression.py)
                # commits with the params it pairs with, so a resumed
                # compressed fit continues the same trajectory
                save_tree_npz(os.path.join(tmp, _COMP_FILE), comp_state)
            write_meta(tmp)
            os.replace(tmp, final)  # the commit point

        with tm.span("elastic.checkpoint_commit", step=step):
            if self.retry is not None:
                self.retry.run(attempt, name="checkpoint_save",
                               retry_on=(OSError, ValueError))
            else:
                attempt()
        self._committed_steps.add(step)
        self.checkpoints_total += 1
        self.last_checkpoint_step = step
        tm.counter("elastic.checkpoints_total")
        tm.gauge("elastic.last_checkpoint_step", step)
        for hook in list(self._commit_hooks):
            try:
                hook(step)
            except Exception as e:  # noqa: BLE001 - an observer
                self.commit_hook_errors_total += 1
                tm.counter("elastic.commit_hook_errors_total")
                if self.log:
                    self.log(f"WARNING: checkpoint commit hook failed at "
                             f"step {step}: {e!r}")
        self._rotate()

    def save(self, step: int, model, extra_meta: Optional[dict] = None,
             block: bool = True) -> None:
        """Checkpoint ``model`` at ``step``; ``extra_meta`` goes to the
        sidecar. ``block=False`` copies the state to the host here and
        commits on a background thread."""
        self.wait_until_finished()
        state = self._state(model)
        comp = getattr(model, "_grad_comp_state", None)
        if comp is not None:
            comp = _host_tree(comp)
        if block:
            self._commit(step, state, extra_meta, comp)
            return

        def run():
            try:
                self._commit(step, state, extra_meta, comp)
            except BaseException as e:  # noqa: BLE001 - crosses the thread
                with self._lock:
                    self._pending_error = e
                    self.checkpoint_errors_total += 1
                tm.counter("elastic.checkpoint_errors_total")

        t = threading.Thread(target=run, name="dl4j-torch-ckpt", daemon=True)
        self._pending = t
        t.start()

    def wait_until_finished(self) -> None:
        """Join an in-flight async save; re-raise its failure once."""
        t = self._pending
        if t is not None:
            t.join()
            self._pending = None
        with self._lock:
            err, self._pending_error = self._pending_error, None
        if err is not None:
            raise err

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)
        for name in os.listdir(self.directory):
            if not name.startswith((_TMP_PREFIX, ".replaced-")):
                continue
            path = os.path.join(self.directory, name)
            if (name.startswith(_TMP_PREFIX)
                    and name.endswith(f"-{os.getpid()}")):
                shutil.rmtree(path, ignore_errors=True)
                continue
            try:
                if time.time() - os.stat(path).st_mtime > 3600:
                    shutil.rmtree(path, ignore_errors=True)
            except OSError:
                pass

    # --------------------------------------------------------------- listing
    def all_steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_meta(self, step: int) -> Dict[str, Any]:
        """The sidecar of ``step`` ({} when absent)."""
        path = os.path.join(self.directory, str(step), _META_FILE)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    # --------------------------------------------------------------- restore
    def restore(self, model, step: Optional[int] = None):
        """Restore into an init()'d model of the same configuration, in
        place (its captured programs are dropped)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, str(step))
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{self.directory}")

        def attempt():
            return load_tree_npz(os.path.join(path, _STATE_FILE))

        with tm.span("elastic.checkpoint_restore", step=step):
            restored = (self.retry.run(attempt, name="checkpoint_restore",
                                       retry_on=(OSError,))
                        if self.retry is not None else attempt())
        for name in ("params", "states", "opt_states"):
            _fill(name, getattr(model, name), restored[name])
        meta = restored["meta"]
        model.iteration = int(meta["iteration"])
        model.epoch = int(self.load_meta(step).get("epoch", meta["epoch"]))
        gen = getattr(model, "_gen", None)
        if gen is not None and "torch_generator" in meta and bytes(
                np.asarray(meta["torch_generator_device"])).decode() == \
                gen.device.type:
            gen.set_state(torch.from_numpy(
                np.array(meta["torch_generator"], copy=True)))
        # the gradient-compression sidecar: ParallelWrapper adopts the
        # restored residual and threshold at its next step; a checkpoint
        # without one clears a live state (the restored params never saw
        # that residual)
        comp_path = os.path.join(path, _COMP_FILE)
        if os.path.exists(comp_path):
            model._grad_comp_state = load_tree_npz(comp_path)
        elif getattr(model, "_grad_comp_state", None) is not None:
            model._grad_comp_state = None
        model._drop_programs()
        return model

    def restore_latest_good(self, model) -> Optional[int]:
        """Walk the steps newest first; a step that fails to load is
        counted, logged and renamed aside (never deleted), and the next
        older one tried. Returns the restored step, or None."""
        for step in reversed(self.all_steps()):
            try:
                self.restore(model, step=step)
                return step
            except Exception as e:  # noqa: BLE001 - skip bad, keep walking
                self.corrupt_skipped_total += 1
                tm.counter("checkpoint.corrupt_skipped_total")
                tm.instant("checkpoint.corrupt_skipped", step=step,
                           error=f"{type(e).__name__}: {e}"[:200])
                if self.log:
                    self.log(f"WARNING: checkpoint step {step} in "
                             f"{self.directory} failed to load "
                             f"({type(e).__name__}: {e}); trying older")
                src = os.path.join(self.directory, str(step))
                dst = os.path.join(self.directory,
                                   f".unloadable-{step}-{os.getpid()}")
                try:
                    if not os.path.exists(dst):
                        os.replace(src, dst)
                except OSError:
                    pass
        return None

    def close(self):
        self.wait_until_finished()


class ShardedCheckpointListener:
    """CheckpointListener over the sharded format: save every
    ``frequency`` iterations, keep the last N. At an epoch's end the step
    just saved is saved again (the same-step path refreshes only the
    sidecar's epoch), so a restore from it starts the next epoch."""

    def __init__(self, directory, frequency: int = 1000, keep: int = 3,
                 block: bool = True):
        """``directory``: a path, or a ShardedCheckpointer."""
        self.ckpt = (directory if isinstance(directory, ShardedCheckpointer)
                     else ShardedCheckpointer(directory, keep=keep))
        self.frequency = frequency
        self.block = block

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.ckpt.save(iteration, model, block=self.block)

    def on_epoch_end(self, model):
        self.ckpt.wait_until_finished()
        if model.iteration in self.ckpt._committed_steps:
            self.ckpt.save(model.iteration, model, block=self.block)


class FaultTolerantTrainer:
    """Checkpoint-restart training: ``fit`` runs under a
    :class:`ShardedCheckpointListener`; a RuntimeError, MemoryError or
    FloatingPointError rolls the model back to the newest checkpoint that
    loads and fits the remaining epochs, up to ``max_restarts`` times."""

    def __init__(self, model, directory: str, checkpoint_every: int = 1000,
                 keep: int = 3, max_restarts: int = 3,
                 crash_dump_path: Optional[str] = None):
        self.model = model
        self.ckpt = ShardedCheckpointer(directory, keep=keep)
        self.listener = ShardedCheckpointListener(self.ckpt,
                                                  frequency=checkpoint_every)
        self.max_restarts = max_restarts
        self.crash_dump_path = crash_dump_path
        self.restarts = 0

    def _crash_dump(self, error):
        """CrashReportingUtil's dump of the model and the failure (reference
        ``:492-494``)."""
        from deeplearning4j_tpu_torch.util.stats import CrashReportingUtil

        CrashReportingUtil.write_crash_dump(self.model, self.crash_dump_path,
                                            error)

    def fit(self, iterator, epochs: int = 1):
        if self.listener not in self.model.listeners:
            self.model.listeners.append(self.listener)
        try:
            while True:
                try:
                    start_epoch = self.model.epoch
                    self.model.fit(iterator, epochs=epochs - start_epoch)
                    self.ckpt.wait_until_finished()
                    return self.model
                except (RuntimeError, MemoryError, FloatingPointError) as e:
                    self.restarts += 1
                    if self.crash_dump_path:
                        self._crash_dump(e)
                    self.ckpt.wait_until_finished()
                    if (self.restarts > self.max_restarts
                            or self.ckpt.latest_step() is None):
                        raise
                    if self.ckpt.restore_latest_good(self.model) is None:
                        raise
        finally:
            if self.listener in self.model.listeners:
                self.model.listeners.remove(self.listener)
