"""The elastic fault-tolerant training runtime (counterpart of
deeplearning4j_tpu/parallel/elastic.py).

- :class:`FileMembership` (reference ``:95``): heartbeat membership over a
  shared directory. Members rewrite ``hb-<id>.json`` from a daemon thread;
  the lowest-id live member coordinates the epoch-boundary regroup, which
  shrinks the world when a member misses its heartbeats (and re-admits a
  restarted one at the next boundary), with coordinator failover when the
  coordinator itself dies. Batch ``i`` belongs to ``i % world == rank``
  under the view a regroup agreed.
- :class:`ElasticTrainer` (reference ``:468``): the supervised loop around
  a network's step, or a ``ParallelWrapper``'s (a ``PipelinedTrainer``'s
  too): periodic atomic checkpoints that carry the iterator cursor and the
  dropout generator's state, auto-resume from the newest good one,
  graceful drain on SIGTERM (finish the step, checkpoint, leave), rollback
  to the last good checkpoint on a health anomaly
  (``util/health.py`` ``RollbackSignal``) within ``max_rollbacks``, and
  ``publish_archive``: a ModelSerializer archive at every checkpoint,
  written by one background thread, which a ``ModelRouter.watch`` serves.
  A ``PipelinedTrainer``'s stacked state is synced back to the network
  before every checkpoint and adopted again after a restore.
- The fault seams (``util/faults.py``) fire on the real paths: ``inject_nan``
  poisons a real batch, ``sigkill_host`` kills the real process,
  ``drop_heartbeat`` silences a member's beat thread.

One process steps one replica: with world > 1 each process trains its own
copy on its share of the batches, as the reference does on its CPU
backend (``:34-39``); the control plane (membership, checkpoints, regroup)
is what runs across processes. Ranks as lanes of one step over
``torch.distributed`` are ROADMAP item 10c.

``inject_nan`` fills floating features with NaN, as the reference does;
integer features (token ids, which a NaN cannot stand in for) keep their
values and the labels take the NaN instead, so the loss is non-finite
either way.

    trainer = ElasticTrainer(net, "/ckpts/run1", checkpoint_every=200)
    trainer.fit(iterator, epochs=10)       # resumes automatically
"""

from __future__ import annotations

import copy
import json
import os
import signal
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.util import faults as fl
from deeplearning4j_tpu_torch.util import telemetry as tm
from deeplearning4j_tpu_torch.util.checkpoint import ShardedCheckpointer
from deeplearning4j_tpu_torch.util.faults import RetryPolicy


class MembershipError(RuntimeError):
    """The membership protocol failed: a barrier's deadline passed, or this
    member was evicted from the published view."""


@dataclass(frozen=True)
class MembershipView:
    """One agreed epoch-scoped membership (reference ``:71``): sorted member
    ids and this member's rank among them."""

    epoch: int
    members: tuple
    rank: int

    @property
    def world(self) -> int:
        return len(self.members)

    def owns_batch(self, index: int) -> bool:
        return index % self.world == self.rank


def _atomic_write(path: str, payload: dict):
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


class FileMembership:
    """Heartbeat membership over a shared directory (see the module doc).

    A member whose newest heartbeat is older than ``(miss_threshold + 1) x
    heartbeat_interval`` (measured against this member's own latest beat,
    on the filesystem's clock), or who posted ``left-<id>``, is dead.
    :meth:`regroup` is the epoch-boundary barrier: every member posts
    ``ready-<epoch>-<id>``, the lowest-id live member waits (up to
    ``barrier_timeout``) for every live member and publishes
    ``view-<epoch>.json`` with an exclusive create, and everyone adopts
    it."""

    def __init__(self, directory: str, process_id: int, world_size: int = 1,
                 heartbeat_interval: float = 0.5, miss_threshold: int = 4,
                 barrier_timeout: float = 120.0,
                 join_grace: Optional[float] = None,
                 injector=None, log_fn=print):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.process_id = int(process_id)
        #: members expected at the first join barrier, held open for them
        #: up to ``join_grace`` seconds (default half the barrier timeout)
        self.world_size = int(world_size)
        self.heartbeat_interval = heartbeat_interval
        self.miss_threshold = miss_threshold
        self.barrier_timeout = barrier_timeout
        self.join_grace = (join_grace if join_grace is not None
                           else barrier_timeout / 2)
        self.injector = injector if injector is not None else fl.get_injector()
        self.log = log_fn
        self.view: Optional[MembershipView] = None
        self.regroups = 0
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._skip_beats = 0

    # ------------------------------------------------------------ heartbeats
    def _hb_path(self, member: int) -> str:
        return os.path.join(self.directory, f"hb-{member}.json")

    def _beat(self):
        self._seq += 1
        _atomic_write(self._hb_path(self.process_id),
                      {"id": self.process_id, "seq": self._seq,
                       "ts": time.time()})
        tm.counter("elastic.heartbeats_total")

    def _beat_loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            fault = self.injector.fire(fl.DROP_HEARTBEAT)
            if fault is not None:
                # long enough a silence to be declared dead
                self._skip_beats = int(fault.arg or (self.miss_threshold + 2))
            if self._skip_beats > 0:
                self._skip_beats -= 1
                tm.counter("elastic.heartbeats_dropped_total")
                continue
            self._beat()

    def start(self) -> "FileMembership":
        left = os.path.join(self.directory, f"left-{self.process_id}")
        if os.path.exists(left):  # rejoin after a graceful leave
            os.unlink(left)
        self._stop.clear()
        self._beat()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._beat_loop, name="dl4j-torch-heartbeat",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, graceful: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if graceful:
            _atomic_write(os.path.join(
                self.directory, f"left-{self.process_id}"),
                {"id": self.process_id, "ts": time.time()})

    # -------------------------------------------------------------- liveness
    def alive(self) -> List[int]:
        """Member ids with a fresh heartbeat and no leave marker, this one
        included (reference ``:206``)."""
        fresh_s = (self.miss_threshold + 1) * self.heartbeat_interval
        stamps = {}
        for name in os.listdir(self.directory):
            if not name.startswith("hb-") or ".tmp-" in name:
                continue
            try:
                member = int(name[len("hb-"):].split(".")[0])
                stamps[member] = os.stat(
                    os.path.join(self.directory, name)).st_mtime
            except (OSError, ValueError):
                continue  # a replace in flight: missing for this scan
        ref = stamps.get(self.process_id, max(stamps.values(), default=0.0))
        out = {self.process_id}
        for member, ts in stamps.items():
            if os.path.exists(os.path.join(self.directory, f"left-{member}")):
                continue
            if ref - ts <= fresh_s:
                out.add(member)
        return sorted(out)

    # --------------------------------------------------------------- regroup
    def _view_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"view-{epoch}.json")

    def _ready_ids(self, epoch: int) -> List[int]:
        prefix = f"ready-{epoch}-"
        out = []
        for n in os.listdir(self.directory):
            if not n.startswith(prefix):
                continue
            try:
                out.append(int(n[len(prefix):]))
            except ValueError:
                continue  # a peer's ".tmp-<pid>" write in flight
        return sorted(out)

    def regroup(self, epoch: int,
                timeout: Optional[float] = None) -> MembershipView:
        """The epoch-boundary barrier and view agreement (reference
        ``:266``)."""
        _atomic_write(os.path.join(
            self.directory, f"ready-{epoch}-{self.process_id}"),
            {"id": self.process_id, "ts": time.time()})
        t0 = time.monotonic()
        deadline = t0 + (timeout or self.barrier_timeout)
        with tm.span("elastic.regroup", epoch=epoch):
            while True:
                view = self._try_adopt(epoch)
                if view is None and min(self.alive()) == self.process_id:
                    view = self._coordinate(epoch, time.monotonic() - t0)
                if view is not None:
                    return self._install(view)
                if time.monotonic() > deadline:
                    raise MembershipError(
                        f"member {self.process_id}: no view for epoch "
                        f"{epoch} within {timeout or self.barrier_timeout}s "
                        f"(alive={self.alive()}, "
                        f"ready={self._ready_ids(epoch)})")
                time.sleep(self.heartbeat_interval / 4)

    def _try_adopt(self, epoch: int) -> Optional[MembershipView]:
        path = self._view_path(epoch)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None  # read mid-replace; the next poll sees it whole
        members = tuple(sorted(int(m) for m in data["members"]))
        if self.process_id not in members:
            raise MembershipError(
                f"member {self.process_id} evicted from epoch-{epoch} view "
                f"{members} (presumed dead); rejoin at the next boundary")
        return MembershipView(epoch=epoch, members=members,
                              rank=members.index(self.process_id))

    def _coordinate(self, epoch: int,
                    elapsed: float = 0.0) -> Optional[MembershipView]:
        """One coordinator poll (reference ``:315``): publish the view once
        every live member is ready; None while one is not."""
        alive = set(self.alive())
        ready = set(self._ready_ids(epoch))
        if not alive <= ready:
            return None
        if (self.view is None and len(alive) < self.world_size
                and elapsed < self.join_grace):
            return None  # the first barrier waits for slow-booting members
        members = tuple(sorted(alive))
        # exclusive create: of two members that both believe they are the
        # lowest live id, the second publish fails and adopts the first
        payload = {"epoch": epoch, "members": list(members),
                   "coordinator": self.process_id, "ts": time.time()}
        path = self._view_path(epoch)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        try:
            try:
                os.link(tmp, path)  # atomic, fails if it exists
            except FileExistsError:
                return self._try_adopt(epoch)
            except OSError:
                # no hard links on this mount: exclusive create instead
                try:
                    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                except FileExistsError:
                    return self._try_adopt(epoch)
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return MembershipView(epoch=epoch, members=members,
                              rank=members.index(self.process_id))

    def _install(self, view: MembershipView) -> MembershipView:
        prev = self.view
        if prev is not None and prev.members != view.members:
            self.regroups += 1
            tm.counter("elastic.regroups_total")
            tm.instant("elastic.regroup_event", epoch=view.epoch,
                       world=view.world, members=str(list(view.members)))
            if self.log:
                self.log(f"ELASTIC regroup at epoch {view.epoch}: "
                         f"{list(prev.members)} -> {list(view.members)} "
                         f"(rank {view.rank}/{view.world})")
        self.view = view
        tm.set_health("elastic.membership", True,
                      f"epoch {view.epoch}: rank {view.rank}/{view.world}")
        # ready markers from two epochs back go; views stay (a member that
        # rolls back re-adopts an old view instead of waiting at a barrier)
        for name in os.listdir(self.directory):
            if name.startswith("ready-"):
                try:
                    old = int(name[len("ready-"):].split("-")[0])
                except ValueError:
                    continue
                if old <= view.epoch - 2:
                    try:
                        os.unlink(os.path.join(self.directory, name))
                    except OSError:
                        pass
        return view

    def status(self) -> dict:
        v = self.view
        return {
            "process_id": self.process_id,
            "alive": self.alive(),
            "world": v.world if v else None,
            "rank": v.rank if v else None,
            "members": list(v.members) if v else None,
            "epoch": v.epoch if v else None,
            "regroups": self.regroups,
            "heartbeat_interval_s": self.heartbeat_interval,
            "miss_threshold": self.miss_threshold,
        }


# --------------------------------------------------------------- publisher
class _ArchivePublisher:
    """One background writer for the train-to-serve seam (reference
    ``:374``): the training thread hands over a host ``snapshot`` and goes
    on stepping; this thread compresses and atomically replaces the
    archive. One pending slot, latest wins."""

    def __init__(self, path: str, log_fn=None):
        self.path = path
        self.log = log_fn
        self._cv = threading.Condition()
        self._pending = None  # (snapshot, step) | None
        self._busy = False
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="elastic-publish")
        self._thread.start()

    def publish(self, snap: dict, step: int):
        with self._cv:
            self._pending = (snap, step)
            self._cv.notify_all()

    def _loop(self):
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer

        while True:
            with self._cv:
                while self._pending is None and not self._stop:
                    self._cv.wait(timeout=0.2)
                if self._pending is None:
                    return  # stopped with nothing left to write
                (snap, step), self._pending = self._pending, None
                self._busy = True
            try:
                with tm.span("elastic.publish", step=step):
                    ModelSerializer.write_snapshot(snap, self.path)
                tm.counter("elastic.publishes_total")
                tm.gauge("elastic.last_publish_step", step)
            except Exception as e:  # noqa: BLE001 - the serving seam
                tm.counter("elastic.publish_errors_total")
                if self.log:
                    self.log(f"ELASTIC publish to {self.path} failed at "
                             f"step {step}: {e!r}")
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def flush(self, timeout: float = 60.0) -> bool:
        """Wait until everything handed to :meth:`publish` is on disk."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._pending is not None or self._busy) \
                    and time.monotonic() < deadline:
                self._cv.wait(timeout=0.1)
            return self._pending is None and not self._busy

    def stop(self, timeout: float = 60.0):
        """Flush, then end the writer thread; a flush that times out is
        counted and logged (the final archive may be stale)."""
        if not self.flush(timeout=timeout):
            tm.counter("elastic.publish_flush_timeouts_total")
            if self.log:
                self.log(f"ELASTIC publish flush timed out after "
                         f"{timeout}s — the final archive at {self.path} "
                         "may be stale")
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)


# ----------------------------------------------------------------- trainer
_ACTIVE: "weakref.WeakValueDictionary[int, ElasticTrainer]" = \
    weakref.WeakValueDictionary()
_ACTIVE_SEQ = 0


def current_status() -> Dict[str, dict]:
    """The live trainers' status, for ``/healthz``'s ``elastic`` section
    and the telemetry collector."""
    return {f"trainer-{k}": t.status() for k, t in sorted(_ACTIVE.items())}


def _nan_like(v):
    if isinstance(v, torch.Tensor):
        return torch.full(v.shape, float("nan"), dtype=torch.float32,
                          device=v.device)
    return np.full(np.shape(v), np.nan, np.float32)


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.issubdtype(np.asarray(v).dtype, np.floating)


class ElasticTrainer:
    """The supervised elastic training loop (see the module doc).

    ``model``: a MultiLayerNetwork or ComputationGraph, or a
    ParallelWrapper (a PipelinedTrainer too), whose inner network is what
    is checkpointed. ``membership=None`` runs one member (world 1) with
    resume, drain and rollback still on. ``checkpoint_every``: steps
    between checkpoints (committed on a background thread unless
    ``async_checkpoint=False``); ``monitor``: the TrainingHealthMonitor to
    install (default one with ``action="rollback"`` when
    ``rollback_on_anomaly``); ``max_rollbacks`` bounds the restore loops;
    ``drain_signals`` are trapped for the graceful drain."""

    def __init__(self, model, directory: str, checkpoint_every: int = 200,
                 keep: int = 3, membership: Optional[FileMembership] = None,
                 monitor=None, rollback_on_anomaly: bool = True,
                 max_rollbacks: int = 3, async_checkpoint: bool = True,
                 initial_checkpoint: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 publish_archive: Optional[str] = None,
                 drain_signals=(signal.SIGTERM,), log_fn=print):
        global _ACTIVE_SEQ
        from deeplearning4j_tpu_torch.parallel.gspmd import is_graph
        from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
        from deeplearning4j_tpu_torch.util.health import TrainingHealthMonitor

        self.wrapper = model if isinstance(model, ParallelWrapper) else None
        self.net = model.model if self.wrapper is not None else model
        # retry=None is the checkpointer's own default, never "no retry"
        if retry is None:
            self.ckpt = ShardedCheckpointer(directory, keep=keep,
                                            log_fn=log_fn)
        else:
            self.ckpt = ShardedCheckpointer(directory, keep=keep,
                                            retry=retry, log_fn=log_fn)
        self.checkpoint_every = checkpoint_every
        self.membership = membership
        self.rollback_on_anomaly = rollback_on_anomaly
        self.max_rollbacks = max_rollbacks
        self.async_checkpoint = async_checkpoint
        self.initial_checkpoint = initial_checkpoint
        #: every checkpoint also publishes a ModelSerializer archive here
        #: (atomic replace), which a ``ModelRouter.watch`` poller reloads
        self.publish_archive = publish_archive
        self._publisher: Optional[_ArchivePublisher] = None
        if self.publish_archive is not None:
            self.ckpt.add_commit_hook(
                lambda step: tm.instant("elastic.commit", step=step,
                                        publish=str(self.publish_archive)))
        self.drain_signals = tuple(drain_signals)
        self.log = log_fn
        if monitor is None and rollback_on_anomaly:
            monitor = TrainingHealthMonitor(action="rollback", log_fn=log_fn)
        self.monitor = monitor

        self.state = "idle"
        self.rollbacks = 0
        self.resumed_from: Optional[int] = None
        self.drained = False
        self._drain_requested = False
        self._batch_in_epoch = 0
        self._steps_since_ckpt = 0
        self._view: Optional[MembershipView] = None
        self._is_graph = is_graph(self.net)
        _ACTIVE_SEQ += 1
        _ACTIVE[_ACTIVE_SEQ] = self

    # ------------------------------------------------------------- stepping
    def _step(self, ds):
        if self.wrapper is not None:
            self.wrapper.step_batch(ds)
        elif self._is_graph:
            from deeplearning4j_tpu_torch.nn.computation_graph import \
                _mask_dict

            feats = (list(ds.features)
                     if isinstance(ds.features, (list, tuple))
                     else [ds.features])
            labs = (list(ds.labels) if isinstance(ds.labels, (list, tuple))
                    else [ds.labels])
            self.net._fit_batch(
                feats, labs,
                mask=_mask_dict(ds, self.net.conf.inputs,
                                "features_mask", "features_masks"),
                label_mask=_mask_dict(ds, self.net.conf.outputs,
                                      "labels_mask", "labels_masks"))
        else:
            self.net._fit_batch(
                ds.features, ds.labels,
                mask=getattr(ds, "features_mask", None),
                label_mask=getattr(ds, "labels_mask", None))

    def _end_epoch(self):
        if self.wrapper is not None:
            self.wrapper.end_epoch()
        else:
            self.net._end_epoch()

    @staticmethod
    def _poison(ds):
        """``inject_nan``: a real poisoned batch, so the detection and the
        rollback exercised are the production ones. Floating features
        become NaN; with integer features (token ids) the labels do."""
        bad = copy.copy(ds)
        feats = ds.features
        many = isinstance(feats, (list, tuple))
        if all(_is_float(f) for f in (feats if many else [feats])):
            bad.features = ([_nan_like(f) for f in feats] if many
                            else _nan_like(feats))
        else:
            labs = ds.labels
            bad.labels = ([_nan_like(y) for y in labs]
                          if isinstance(labs, (list, tuple))
                          else _nan_like(labs))
        return bad

    # ---------------------------------------------------------- checkpoints
    def _checkpoint(self, block: bool = False):
        # flush the listener window, so the monitor judges (and may veto)
        # every step before it is committed as a good checkpoint
        disp = getattr(self.net, "_dispatcher", None)
        if disp is not None:
            disp.flush()
        # a pipelined trainer's live state is stacked: write it back first
        sync = getattr(self.wrapper, "sync_model", None)
        if sync is not None:
            sync()
        meta = {
            "batch_in_epoch": self._batch_in_epoch,
            "epoch": self.net.epoch,
            "world": self._view.world if self._view else 1,
            "rank": self._view.rank if self._view else 0,
        }
        self.ckpt.save(self.net.iteration, self.net, extra_meta=meta,
                       block=block or not self.async_checkpoint)
        if self.publish_archive is not None:
            self._publish()
        self._steps_since_ckpt = 0

    def _publish(self):
        """Hand this checkpoint's weights to the background publisher: the
        host snapshot is taken here, on the training thread, so archive and
        checkpoint carry the same step. A failure is counted and logged,
        never raised: the checkpoint already committed."""
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer

        try:
            snap = ModelSerializer.snapshot(self.net)
        except Exception as e:  # noqa: BLE001 - the serving seam
            tm.counter("elastic.publish_errors_total")
            if self.log:
                self.log(f"ELASTIC publish snapshot failed at step "
                         f"{self.net.iteration}: {e!r}")
            return
        if self._publisher is None:
            self._publisher = _ArchivePublisher(self.publish_archive,
                                                log_fn=self.log)
        self._publisher.publish(snap, self.net.iteration)

    def _restored(self, step: int):
        """After a restore: the cursor from the sidecar, and a stacked
        trainer's state adopted at once."""
        meta = self.ckpt.load_meta(step)
        self._batch_in_epoch = int(meta.get("batch_in_epoch", 0))
        adopt = getattr(self.wrapper, "_adopt_model_state", None)
        if adopt is not None and getattr(self.wrapper, "_built", False):
            adopt()

    def _resume(self) -> Optional[int]:
        step = self.ckpt.restore_latest_good(self.net)
        if step is None:
            return None
        self._restored(step)
        self.resumed_from = step
        tm.counter("elastic.resumes_total")
        tm.instant("elastic.resume", step=step, epoch=self.net.epoch,
                   batch_in_epoch=self._batch_in_epoch)
        if self.log:
            self.log(f"ELASTIC resume from checkpoint step {step} "
                     f"(epoch {self.net.epoch}, "
                     f"batch {self._batch_in_epoch})")
        return step

    def _rollback(self, sig):
        if self.rollbacks >= self.max_rollbacks:
            raise RuntimeError(
                f"elastic rollback budget exhausted "
                f"({self.max_rollbacks}); last anomaly: {sig}") from sig
        self.ckpt.wait_until_finished()
        step = self.ckpt.restore_latest_good(self.net)
        if step is None:
            raise RuntimeError(
                "health anomaly with no checkpoint to roll back to"
            ) from sig
        self.rollbacks += 1
        self._restored(step)
        self._steps_since_ckpt = 0
        if self.monitor is not None:
            self.monitor.reset()  # its bands described the poisoned run
        tm.counter("elastic.rollbacks_total")
        tm.instant("elastic.rollback", step=step, kind=sig.kind)
        tm.set_health("elastic.rollback", True,
                      f"rolled back to step {step} after {sig.kind}")
        if self.log:
            self.log(f"ELASTIC rollback to checkpoint step {step} after "
                     f"{sig.kind} ({sig.detail}); "
                     f"{self.max_rollbacks - self.rollbacks} budget left")

    # ---------------------------------------------------------------- drain
    def _on_drain_signal(self, signum, frame):
        self._drain_requested = True
        tm.counter("elastic.drain_signals_total")
        if self.log:
            self.log(f"ELASTIC drain requested (signal {signum}): finishing "
                     "the in-flight step, checkpointing, leaving")

    # ------------------------------------------------------------------ fit
    def fit(self, iterator, epochs: int = 1):
        """Supervised fit (reference ``:666``): resume, then (regroup,
        shard, step and checkpoint) per epoch, then a final checkpoint.
        ``epochs`` is the ABSOLUTE target epoch count, so a resumed call
        with the same arguments does the same total work. Returns the
        network; ``drained`` says a drain ended it."""
        from deeplearning4j_tpu_torch.util.health import RollbackSignal

        injector = fl.get_injector()
        net = self.net
        self.state = "running"
        self._drain_requested = False
        self.drained = False
        installed_monitor = False
        if self.monitor is not None and self.monitor not in net.listeners:
            net.listeners.append(self.monitor)
            installed_monitor = True
        old_handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in self.drain_signals:
                old_handlers[sig] = signal.signal(sig, self._on_drain_signal)
        if self.membership is not None:
            self.membership.start()
        try:
            if self._resume() is None:
                self._batch_in_epoch = 0
                if self.initial_checkpoint:
                    # a rollback target before the first anomaly can hit
                    self._checkpoint(block=True)
            while net.epoch < epochs:
                if self.membership is not None:
                    prev_view = self._view
                    self._view = self.membership.regroup(net.epoch)
                    if (self.wrapper is not None and prev_view is not None
                            and self._view.world != prev_view.world):
                        # the world changed at the barrier: re-place the
                        # state (one device: the same placement)
                        self.wrapper.reshard()
                        tm.instant("elastic.reshard", epoch=net.epoch,
                                   world=self._view.world)
                try:
                    done = self._run_epoch(iterator, injector)
                    if done:
                        self._batch_in_epoch = 0
                        # the epoch-end flush can surface a late window's
                        # anomaly: it lands in the same rollback catch
                        self._end_epoch()
                        self._checkpoint(block=False)
                except RollbackSignal as sig:
                    self._rollback(sig)
                    continue
                if not done:  # drained mid-epoch
                    break
            self.ckpt.wait_until_finished()
            try:
                self._checkpoint(block=True)
            except RollbackSignal as sig:
                # a drain cut a window whose losses carry an anomaly:
                # restore the good state, then save that
                self._rollback(sig)
                self._checkpoint(block=True)
            if self._drain_requested:
                self.drained = True
                self.state = "drained"
                tm.counter("elastic.drains_total")
                tm.set_health("elastic.drained", True,
                              f"drained at step {net.iteration}")
                if self.log:
                    self.log(f"ELASTIC drained at step {net.iteration} "
                             f"(epoch {net.epoch}); checkpoint committed")
            else:
                self.state = "completed"
            return net
        except BaseException:
            self.state = "failed"
            raise
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            if self.membership is not None:
                self.membership.stop(graceful=True)
            try:
                self.ckpt.wait_until_finished()
            except Exception:  # noqa: BLE001 - keep the real error
                pass
            if self._publisher is not None:
                # the final weights' archive is durable when fit returns
                try:
                    self._publisher.stop()
                except Exception:  # noqa: BLE001 - keep the real error
                    pass
                self._publisher = None
            if installed_monitor and self.monitor in net.listeners:
                net.listeners.remove(self.monitor)

    def _run_epoch(self, iterator, injector) -> bool:
        """One epoch under the current view; False when a drain cut it."""
        net = self.net
        if hasattr(iterator, "reset"):
            iterator.reset()
        cursor = self._batch_in_epoch  # batches the checkpoint covers
        for i, ds in enumerate(iterator):
            if i < cursor:
                continue
            if self._view is not None and not self._view.owns_batch(i):
                self._batch_in_epoch = i + 1
                continue
            if injector.fire(fl.SIGKILL_HOST, step=net.iteration):
                os.kill(os.getpid(), signal.SIGKILL)  # hard host loss
            if injector.fire(fl.INJECT_NAN, step=net.iteration) is not None:
                ds = self._poison(ds)
            with tm.span("elastic.step", iteration=net.iteration):
                self._step(ds)
            self._batch_in_epoch = i + 1
            self._steps_since_ckpt += 1
            if self._steps_since_ckpt >= self.checkpoint_every:
                self._checkpoint(block=False)
            if self._drain_requested:
                return False
        return True

    # ---------------------------------------------------------------- status
    def status(self) -> dict:
        out = {
            "state": self.state,
            "epoch": self.net.epoch,
            "iteration": self.net.iteration,
            "checkpoint_dir": self.ckpt.directory,
            "last_checkpoint_step": self.ckpt.latest_step(),
            "checkpoint_every": self.checkpoint_every,
            "rollbacks": self.rollbacks,
            "resumed_from": self.resumed_from,
            "drained": self.drained,
            "publish_archive": self.publish_archive,
        }
        comp = (getattr(self.wrapper, "_compressor", None)
                if self.wrapper is not None else None)
        if comp is not None:
            out["grad_compression"] = {
                "scheme": comp.scheme, "hosts": comp.hosts,
                "residual_resident": self.wrapper._comp_state is not None}
        if self.membership is not None:
            out["membership"] = self.membership.status()
        else:
            out["membership"] = {"world": 1, "rank": 0, "members": [0]}
        return out


def bootstrap_elastic(membership_dir: str, process_id: int,
                      num_processes: int, coordinator: Optional[str] = None,
                      retry: Optional[RetryPolicy] = None,
                      **membership_kw) -> FileMembership:
    """The process-group bootstrap, then the membership layer (reference
    ``:879``): ``distributed.initialize`` under the retried handshake when
    a ``coordinator`` is given, then heartbeats over ``membership_dir``."""
    from deeplearning4j_tpu_torch.parallel import distributed

    if coordinator is not None:
        distributed.initialize(
            coordinator=coordinator, num_processes=num_processes,
            process_id=process_id,
            retry=retry if retry is not None else distributed.BOOTSTRAP_RETRY)
    return FileMembership(membership_dir, process_id=process_id,
                          world_size=num_processes, **membership_kw)


def collect_elastic_gauges() -> list:
    """Scrape-time elastic gauges (reference ``:901``), a default collector
    of ``util/telemetry.py``."""
    out = []
    for name, st in current_status().items():
        lab = {"trainer": name}
        m = st.get("membership") or {}
        if m.get("world") is not None:
            out.append(("elastic.world_size", lab, float(m["world"])))
        if m.get("alive"):
            out.append(("elastic.alive_members", lab, float(len(m["alive"]))))
        out.append(("elastic.rollbacks", lab, float(st["rollbacks"])))
        out.append(("elastic.drained", lab, 1.0 if st["drained"] else 0.0))
    return out
