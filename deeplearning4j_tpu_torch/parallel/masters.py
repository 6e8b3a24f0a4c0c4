"""Training masters: parameter averaging and shared (compressed) gradient
training, with the Spark-facade entry points (counterpart of
deeplearning4j_tpu/parallel/masters.py, ``:44-291``).

Workers are lanes, as in the reference: a leading worker axis of R lanes,
here run one after another on the mesh's one device.

- :class:`ParameterAveragingTrainingMaster` keeps R divergent copies of
  the params, layer states and optimizer states on the device (lane 0 is
  the network's own tensors), fits each lane on its slice of the batch
  with the network's own weighted step, and averages them by
  ``pairwise_mean`` every ``averaging_frequency`` steps and at the end of
  ``fit``. It dispatches no ``on_epoch_end`` (reference ``:136-142``): the
  lane copies are the fit's own until it returns.
- :class:`SharedTrainingMaster` encodes each lane's gradient with its own
  residual and threshold (``EncodedGradientsAccumulator``), averages the
  quantized trees by the pairwise tree, and applies one update; the
  residuals and thresholds stay with their lanes. Its step is one
  ``nn/capture.Program`` per batch signature (eager within
  ``capture.disabled()``); ``last_stats`` holds the wire accounting of the
  last step. The params live in the network's own tensors, so a listener
  at an epoch's end sees the real state.

The masters' lane gradients are unscaled: a network with a loss-scaling
policy is refused by the shared master (``gspmd.apply_updaters``).
Telemetry: ``train.steps_total`` (``model="shared_master"``), the
``parallel.allreduce_wire_bytes`` and
``parallel.allreduce_compression_ratio`` gauges (``source=
"shared_master"``), read at each epoch's end (the reference reads them
every step, a host sync a step).
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import capture
from deeplearning4j_tpu_torch.parallel import gspmd
from deeplearning4j_tpu_torch.parallel.accumulator import (
    EncodedGradientsAccumulator, div_const)
from deeplearning4j_tpu_torch.parallel.compression import sparse_wire_bytes
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh
from deeplearning4j_tpu_torch.parallel.wrapper import (_batch_masks,
                                                       _float_masks, _lane,
                                                       lane_program)
from deeplearning4j_tpu_torch.tree import tree_copy_, tree_leaves, tree_map
from deeplearning4j_tpu_torch.util import telemetry as tm


def _stack_tree(tree, n):
    """``tree`` with each leaf broadcast to a leading axis of ``n`` (a
    view: clone it before writing)."""
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)), tree)


def _iter(iterator):
    return [iterator] if isinstance(iterator, DataSet) else iterator


def _mesh_for(mesh, model):
    return mesh or TrainingMesh(data=1, devices=[model.device])


class ParameterAveragingTrainingMaster:
    """Sync parameter averaging every ``averaging_frequency`` minibatches
    (reference ``:69``). ``replicas``: the worker lanes (default the mesh's
    ``data`` axis)."""

    def __init__(self, averaging_frequency: int = 5,
                 mesh: Optional[TrainingMesh] = None,
                 replicas: Optional[int] = None):
        self.averaging_frequency = averaging_frequency
        self.mesh = mesh
        self.replicas = replicas

    @staticmethod
    def _average(lanes):
        """Every float leaf of the R lane trees set to the lanes'
        pairwise mean (the rest keep their own values)."""
        with torch.no_grad():
            for leaves in zip(*[tree_leaves(t) for t in lanes]):
                if not leaves[0].is_floating_point():
                    continue
                avg = gspmd.pairwise_mean(torch.stack(leaves))
                for leaf in leaves:
                    leaf.copy_(avg)

    def fit(self, model, iterator, epochs: int = 1):
        mesh = self.mesh = _mesh_for(self.mesh, model)
        n = int(self.replicas or mesh.data)
        clone = lambda t: tree_map(lambda v: v.clone(), t)  # noqa: E731
        own = [model.params, model.states, model.opt_states]
        lanes = [own] + [clone(own) for _ in range(n - 1)]
        since_avg = 0
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in _iter(iterator):
                fm, lm = _batch_masks(ds, model)
                x, y, w, (fm, lm) = mesh.pad_lane_batch(
                    ds.features, ds.labels, n, extras=(fm, lm))
                fm, lm = _float_masks(fm), _float_masks(lm)
                model._step_sizes()
                losses = []
                for r, (p, s, o) in enumerate(lanes):
                    feed, labs = gspmd._lane_feed(model, _lane(x, r),
                                                  _lane(y, r))
                    with gspmd._bound(model, p, s, o):
                        losses.append(model._train_body(
                            feed, labs, w[r], _lane(fm, r), _lane(lm, r)))
                model.iteration += 1
                model.score_value = torch.stack(losses).mean()
                since_avg += 1
                if since_avg >= self.averaging_frequency:
                    for part in range(3):
                        self._average([lane[part] for lane in lanes])
                    since_avg = 0
                for lst in model.listeners:
                    lst.iteration_done(model, model.iteration, model.epoch)
            model.epoch += 1
            # no on_epoch_end here: the lane copies are this loop's until
            # fit() returns, so an epoch-end checkpoint would save
            # pre-average state (reference :136-142)
        if since_avg:
            for part in range(3):
                self._average([lane[part] for lane in lanes])
        return model


class SharedTrainingMaster:
    """Every-step compressed gradient sharing with error feedback
    (reference ``:156``). ``replicas``: the worker lanes (default the
    mesh's ``data`` axis)."""

    def __init__(self, threshold: float = 1e-3,
                 mesh: Optional[TrainingMesh] = None,
                 accumulator: Optional[EncodedGradientsAccumulator] = None,
                 replicas: Optional[int] = None):
        self.mesh = mesh
        self.accumulator = accumulator or EncodedGradientsAccumulator()
        self.initial_threshold = threshold
        self.replicas = replicas
        #: the last step's wire accounting (device scalars)
        self.last_stats = None
        #: the lanes' residuals (R, ...) and thresholds (R,) after the last
        #: step
        self.residual = None
        self.threshold = None
        self._programs: dict = {}
        self._sizes_ref = None
        self.model_ = None
        self.n_ = None

    def _body(self, x, y, w, fm, lm, iteration):
        model, acc = self.model_, self.accumulator
        lane_vg = gspmd.make_lane_value_and_grad(model)
        losses, states_l, quant_l, res_l, thr_l = [], [], [], [], []
        for r in range(self.n_):
            (loss, _), (ns, g) = lane_vg(
                model.params, model.states, _lane(x, r), _lane(y, r), w[r],
                _lane(fm, r), _lane(lm, r))
            q, res, thr, _ratio = acc.encode(g, _lane(self.residual, r),
                                             self.threshold[r], iteration)
            losses.append(loss)
            states_l.append(ns)
            quant_l.append(q)
            res_l.append(res)
            thr_l.append(thr)
        # the pairwise mean of the quantized updates is the exchange
        quant = gspmd.stack_lanes(quant_l)
        shared = gspmd.tree_pairwise_mean(quant)
        gspmd.apply_updaters(model, model.params, shared, model.opt_states,
                             model._sizes.views)
        with torch.no_grad():
            tree_copy_(model.states,
                       gspmd.combine_states(gspmd.stack_lanes(states_l)))
            tree_copy_(self.residual, gspmd.stack_lanes(res_l))
            self.threshold.copy_(torch.stack(thr_l))
        q_leaves = tree_leaves(quant)
        workers = float(q_leaves[0].shape[0]) if q_leaves else 1.0
        nnz = sum((q != 0).sum().to(torch.float32) for q in q_leaves)
        dense = float(sum(int(q[0].numel()) * q.element_size()
                          for q in q_leaves))
        wire = sparse_wire_bytes(len(q_leaves), nnz, workers)
        dense_t = torch.full((), dense, dtype=torch.float32,
                             device=nnz.device)
        stats = torch.stack([wire, dense_t, div_const(wire, dense)])
        return gspmd.pairwise_mean(torch.stack(losses)), stats

    def fit(self, model, iterator, epochs: int = 1):
        mesh = self.mesh = _mesh_for(self.mesh, model)
        if gspmd._lane_scaled(model):
            raise NotImplementedError(
                "loss_scale under this master is not wired: its lane "
                "value-and-grad computes unscaled gradients, so the fused "
                "unscale would corrupt them: use ParallelWrapper (which "
                "scales the lane loss), or keep loss_scale='none' here")
        n = self.n_ = int(self.replicas or mesh.data)
        if self.residual is None or self.model_ is not model:
            self.residual = tree_map(
                lambda v: v.clone(), _stack_tree(
                    self.accumulator.init_residual(
                        gspmd.grad_template(model)), n))
            self.threshold = torch.full((n,), float(self.initial_threshold),
                                        dtype=torch.float32,
                                        device=model.device)
            self._programs = {}
            self.model_ = model
        it_t = torch.zeros((), dtype=torch.int64, device=model.device)
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in _iter(iterator):
                fm, lm = _batch_masks(ds, model)
                x, y, w, (fm, lm) = mesh.pad_lane_batch(
                    ds.features, ds.labels, n, extras=(fm, lm))
                fm, lm = _float_masks(fm), _float_masks(lm)
                sizes = model._step_sizes()
                if sizes is not self._sizes_ref:
                    self._programs, self._sizes_ref = {}, sizes
                it_t.fill_(model.iteration)
                args = (x, y, w, fm, lm, it_t)
                if capture.enabled():
                    prog = lane_program(
                        model, self._programs, capture.dispatch_sig(*args),
                        "SharedTrainingMaster.step", self._body, args,
                        [model.params, model.states, model.opt_states,
                         self.residual, self.threshold])
                    loss, stats = (t.clone() for t in prog(*args))
                else:
                    loss, stats = self._body(*args)
                self.last_stats = dict(zip(
                    ("wire_bytes", "dense_bytes", "ratio"), stats))
                model.iteration += 1
                model.score_value = loss
                tm.counter("train.steps_total", model="shared_master")
                model._dispatcher.iteration_done(loss, model.iteration,
                                                 model.epoch)
            if tm.enabled() and self.last_stats is not None:
                # read once an epoch: a per-step read would wait for the
                # device every step
                tm.gauge("parallel.allreduce_wire_bytes",
                         float(self.last_stats["wire_bytes"]),
                         source="shared_master")
                tm.gauge("parallel.allreduce_compression_ratio",
                         float(self.last_stats["ratio"]),
                         source="shared_master")
            # the params are the network's own tensors, updated in place:
            # an epoch-end listener sees the real state
            model._end_epoch()
        return model


class SparkDl4jMultiLayer:
    """User facade (SparkDl4jMultiLayer.java parity, reference ``:278``):
    a network and a TrainingMaster; the SparkContext is accepted and
    ignored (there is no Spark: the lanes are the cluster)."""

    def __init__(self, sc, network, training_master):
        self.network = network
        self.training_master = training_master

    def fit(self, iterator, epochs: int = 1):
        return self.training_master.fit(self.network, iterator, epochs=epochs)


SparkComputationGraph = SparkDl4jMultiLayer  # the same facade over a graph
