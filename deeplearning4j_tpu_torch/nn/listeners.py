"""Training listeners (counterpart of deeplearning4j_tpu/nn/listeners.py;
org/deeplearning4j/optimize/api/TrainingListener.java and the listeners of
org/deeplearning4j/optimize/listeners/).

A network calls ``iteration_done(model, iteration, epoch)`` on each of its
listeners after every update and ``on_epoch_end(model)`` after every epoch.
Reading ``model.get_score()`` copies one scalar from the device, so it
waits for the step: :class:`ScoreIterationListener` reads it only every
``print_iterations``.

With ``sync_every > 1`` on the conf, ``fit`` routes the calls through
:class:`CoalescingListenerDispatcher`: each step hands over its loss as a
device tensor without waiting for it, and every ``sync_every`` steps (or at
the epoch's end) the window's losses come to the host in one copy, after
which every listener sees every iteration of the window in order, with
``model.score_value`` that iteration's loss as a float. Listeners see the
same (iteration, epoch, score) stream as at ``sync_every`` 1, up to
``sync_every - 1`` iterations late; a listener that times steps reads
:func:`iteration_wall_ns`, the step's own host clock. A captured step
(``nn/capture.py``) hands over a copy of its loss, never the program's
own buffer, which the next replay overwrites: each queued loss is its own
step's.

:class:`RecompileListener` reports a program built after its grace
period: a batch, TBPTT remainder or evaluation shape that paid a warm-up
and a capture inside the training loop.

:class:`CheckpointListener` writes ModelSerializer archives
(``util/model_serializer.py``) every N iterations or epochs and keeps the
last N. Under a coalescing window it runs when the window flushes, as
every listener does, so it adds no host wait beyond ``sync_every``'s; the
archive then holds the net as it stands at the flush (at ``sync_every`` 1,
that iteration's state).

Not ported yet: the dispatcher's telemetry spans (ROADMAP item 12).
"""

from __future__ import annotations

import time

import torch

from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher


def iteration_wall_ns(model) -> int:
    """The host clock of the iteration being dispatched: the step's own
    stamp under coalesced dispatch (``model.last_iteration_wall_ns``), else
    now."""
    ns = getattr(model, "last_iteration_wall_ns", None)
    return ns if ns is not None else time.perf_counter_ns()


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass


class CoalescingListenerDispatcher:
    """Listener dispatch over a ``sync_every`` window (reference
    ``nn/listeners.py:44``). At ``sync_every`` 1 it calls the listeners at
    once; above 1 it queues (iteration, epoch, device loss, host clock) and
    :meth:`flush` fetches a full window's losses with one
    ``torch.stack(...).tolist()``. With no listeners it does nothing, so
    the step chain never waits on the host. ``fetches`` counts the
    copies."""

    def __init__(self, model, sync_every: int = 1):
        self.model = model
        self.sync_every = max(1, int(sync_every))
        self._pending: list = []  # (iteration, epoch, device loss, wall ns)
        self.fetches = 0

    def iteration_done(self, loss, iteration: int, epoch: int) -> None:
        model = self.model
        if not model.listeners:
            return
        if self.sync_every <= 1:
            for lst in model.listeners:
                lst.iteration_done(model, iteration, epoch)
            return
        self._pending.append((iteration, epoch, loss, time.perf_counter_ns()))
        if len(self._pending) >= self.sync_every:
            self.flush()

    def flush(self) -> None:
        """Fetch the pending losses in one copy and dispatch them in
        order."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        vals = torch.stack([torch.as_tensor(p[2], dtype=torch.float32)
                            for p in pending]).tolist()
        self.fetches += 1
        model = self.model
        try:
            for (it, ep, _, wall_ns), val in zip(pending, vals):
                model.score_value = val
                model.last_iteration_wall_ns = wall_ns
                for lst in model.listeners:
                    lst.iteration_done(model, it, ep)
        finally:
            model.last_iteration_wall_ns = None


class RecompileListener(TrainingListener):
    """After a ``grace`` of initial iterations (the expected first builds),
    every new trace of a watched function, a program built for a new
    signature, is logged with the signature that caused it (reference
    ``nn/listeners.py:105-133``). ``events`` keeps (iteration, function,
    new traces)."""

    def __init__(self, grace: int = 1, log_fn=print):
        self.grace = grace
        self.log = log_fn
        self.events: list = []  # (iteration, fn_name, new_trace_count)
        self._watcher = get_watcher()
        self._seen: dict = dict(self._watcher.traces)

    def iteration_done(self, model, iteration, epoch):
        cur = self._watcher.traces
        for fn, n in cur.items():
            prev = self._seen.get(fn, 0)
            if n > prev and iteration > self.grace:
                self.events.append((iteration, fn, n - prev))
                shapes = self._watcher.shapes.get(fn, {})
                last = next(reversed(list(shapes))) if shapes else "?"
                self.log(
                    f"RECOMPILE at iteration {iteration}: {fn} retraced "
                    f"(+{n - prev}, total {n}) for signature {last}")
        self._seen = dict(cur)


class ScoreIterationListener(TrainingListener):
    def __init__(self, print_iterations: int = 10, log_fn=print):
        self.print_iterations = print_iterations
        self.log = log_fn

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.print_iterations == 0:
            self.log(f"Score at iteration {iteration} is "
                     f"{model.get_score():.6f}")


class PerformanceListener(TrainingListener):
    """Iterations/sec every ``frequency`` iterations (PerformanceListener
    parity), on the steps' own clock under coalesced dispatch."""

    def __init__(self, frequency: int = 10, log_fn=print):
        self.frequency = frequency
        self.log = log_fn
        self._last_time = None
        self._last_iter = 0

    def iteration_done(self, model, iteration, epoch):
        now = iteration_wall_ns(model) / 1e9
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            return
        if iteration - self._last_iter >= self.frequency:
            dt = now - self._last_time
            ips = (iteration - self._last_iter) / dt if dt > 0 else float(
                "inf")
            self.log(f"iteration {iteration}: {ips:.1f} iter/sec")
            self._last_time = now
            self._last_iter = iteration


class CollectScoresListener(TrainingListener):
    """Keeps (iteration, score) every ``frequency`` iterations
    (CollectScoresIterationListener parity)."""

    def __init__(self, frequency: int = 1):
        self.frequency = frequency
        self.scores: list = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.get_score()))


class CheckpointListener(TrainingListener):
    """Periodic keep-N ModelSerializer checkpoints
    (CheckpointListener.java: saveEveryNIterations, saveEveryNEpochs,
    keepLast), named ``checkpoint_iter<i>_epoch<e>.zip``."""

    def __init__(self, directory: str, save_every_n_iterations: int = 0,
                 save_every_n_epochs: int = 0, keep_last: int = 0,
                 save_updater: bool = True):
        import os

        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.save_every_n_iterations = save_every_n_iterations
        self.save_every_n_epochs = save_every_n_epochs
        self.keep_last = keep_last
        self.save_updater = save_updater
        self.saved: list = []

    def _save(self, model, iteration, epoch):
        import os

        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer

        path = os.path.join(self.directory,
                            f"checkpoint_iter{iteration}_epoch{epoch}.zip")
        ModelSerializer.write_model(model, path,
                                    save_updater=self.save_updater)
        self.saved.append(path)
        while self.keep_last and len(self.saved) > self.keep_last:
            old = self.saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def iteration_done(self, model, iteration, epoch):
        if (self.save_every_n_iterations
                and iteration % self.save_every_n_iterations == 0):
            self._save(model, iteration, epoch)

    def on_epoch_end(self, model):
        if (self.save_every_n_epochs
                and model.epoch % self.save_every_n_epochs == 0):
            self._save(model, model.iteration, model.epoch)

    def last_checkpoint(self):
        return self.saved[-1] if self.saved else None


class EvaluativeListener(TrainingListener):
    """``model.evaluate`` on a held-out iterator every ``frequency``
    iterations (EvaluativeListener parity)."""

    def __init__(self, iterator, frequency: int = 100, log_fn=print):
        self.iterator = iterator
        self.frequency = frequency
        self.log = log_fn
        self.last_evaluation = None

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.last_evaluation = model.evaluate(self.iterator)
            self.log(f"iteration {iteration}: "
                     f"accuracy={self.last_evaluation.accuracy():.4f}")
