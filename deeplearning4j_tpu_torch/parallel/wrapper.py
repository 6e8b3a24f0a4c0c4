"""ParallelWrapper and ParallelInference (counterpart of
deeplearning4j_tpu/parallel/wrapper.py).

**ParallelWrapper** (reference ``:38-1005``) fits a network over a
``TrainingMesh``. Two modes:

- the fast step (``:280``): on one device it is the network's own weighted
  step on the batch, the same ``nn/capture.py`` program ``fit`` runs, so it
  equals ``net.fit`` on that batch bit for bit;
- the lane step (``deterministic=True``, or any active
  ``grad_compression``; ``:420-453``): the batch padded to ``replicas``
  lanes (``TrainingMesh.pad_lane_batch``), each lane's gradients from the
  network's own ``_gradients`` (``parallel/gspmd.py``), weighted by the
  lane's loss-weight mass, combined by the pairwise tree (or by the
  compressed exchange, ``parallel/compression.py``, on the fused engine's
  flat buffers when the conf fuses), the batchnorm states averaged, then
  one update. TBPTT batches of a MultiLayerNetwork run the segment loop
  with every segment one lane step, the carries lane by lane
  (``:455-571``).

The lane step is one ``nn/capture.Program`` per batch signature (a CUDA
graph on the card; on the CPU the same body runs eagerly on the static
buffers), reading and updating in place the params, layer states,
optimizer states and the compression state (residual, threshold). Within
``capture.disabled()`` it runs eagerly. Dynamic loss scaling with
compression is refused (``:143-152``): the residual accumulates in scaled
units.

The compression state is ``model._grad_comp_state`` (the checkpointer's
sidecar, ``util/checkpoint.py``): a state set from outside (a restore, a
rollback) is adopted at the next step, copied into the resident tensors so
the captured programs keep reading them; a restore without a sidecar
resets it. ``warmup`` builds the programs, whose capture restores every
tensor its warm-up runs touched, the residual included.

Telemetry (the reference's names): ``parallel.step`` and
``parallel.tbptt_step`` spans, ``parallel.replica_step`` events and the
``parallel.straggler_skew_seconds`` / ``parallel.replicas`` gauges from
the skew probe (one device: one shard, skew 0), the layout gauges
``parallel.mesh_axis_size``, ``parallel.zero_state_sharded_fraction``,
``parallel.opt_state_bytes_per_device``, ``parallel.grad_compression_hosts``,
the ``parallel.allreduce_*`` gauges and counters of
:meth:`ParallelWrapper.compression_stats`, ``parallel.reshards_total``.

**ParallelInference** (``:1007-1205``): ``output`` plans a request with
``plan_serving_batch(n, cap=batch_limit)`` and runs each chunk through the
network's forward (its captured program per bucket); ``output_async``
coalesces queued requests on a worker thread, where a bad request fails
its batch and not the worker.

Meshes of more than one device, ZeRO placement and ``zero_optimizer`` on
them are ROADMAP item 10c; on one device ``zero_optimizer`` is a no-op, as
in the reference (``:169``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.device import as_tensor
from deeplearning4j_tpu_torch.nn import capture
from deeplearning4j_tpu_torch.parallel import gspmd
from deeplearning4j_tpu_torch.parallel.mesh import (TrainingMesh,
                                                    multi_device_error)
from deeplearning4j_tpu_torch.tree import (tree_copy_, tree_leaves,
                                           tree_map)
from deeplearning4j_tpu_torch.util import telemetry as tm

#: the order of the compression stats in a lane step's stats vector
STATS = ("wire_bytes", "dense_bytes", "ratio", "nnz", "elements", "workers")


def _batch_masks(ds, model):
    """A batch's (feature mask, label mask) as the network's loss takes
    them (reference ``masters.py:52``): a graph's dicts by name for a
    MultiDataSet, else one array."""
    from deeplearning4j_tpu_torch.nn.computation_graph import _mask_dict

    if gspmd.is_graph(model):
        return (_mask_dict(ds, model.conf.inputs, "features_mask",
                           "features_masks"),
                _mask_dict(ds, model.conf.outputs, "labels_mask",
                           "labels_masks"))

    def first(singular, plural):
        m = getattr(ds, singular, None)
        if m is not None:
            return m
        ms = getattr(ds, plural, None)
        return ms[0] if ms else None

    return (first("features_mask", "features_masks"),
            first("labels_mask", "labels_masks"))


def _ndim(v) -> int:
    return v.dim() if isinstance(v, torch.Tensor) else np.ndim(v)


def _float_masks(masks):
    return tree_map(lambda m: m.float(), masks)


def _lane(v, r):
    """Lane ``r`` of a lane-stacked argument (a tensor, a tuple of them,
    a dict of masks, or None)."""
    return tree_map(lambda t: t[r], v)


def lane_program(model, table, key, fn_name, body, args, state_trees,
                 trace_args=None, owner=None) -> capture.Program:
    """``table[key]``, built from ``args`` when missing, in ``owner``'s
    graph pool (the network's by default): a program whose body updates
    ``state_trees`` in place (and draws from the network's dropout
    generator). An owner that drops its programs drops its pool with them:
    torch 2.11's pinned-host allocator refuses a capture into a pool whose
    graphs have all died (an internal assert at ``capture_begin``)."""
    owner = model if owner is None else owner
    prog = table.get(key)
    if prog is None:
        if owner._pool is None and model.device.type == "cuda":
            owner._pool = torch.cuda.graph_pool_handle()
        prog = table[key] = capture.Program(
            fn_name, body, args, device=model.device, pool=owner._pool,
            state=tree_leaves(state_trees), generators=(model._gen,),
            trace_args=trace_args)
    return prog


class ParallelWrapper:
    """Data-parallel fit over a one-device mesh (see the module doc)."""

    def __init__(self, model, workers: Optional[int] = None,
                 mesh: Optional[TrainingMesh] = None, prefetch: int = 2,
                 skew_every: int = 10, zero_optimizer: bool = True,
                 deterministic: bool = False, replicas: Optional[int] = None,
                 grad_compression=None,
                 compression_threshold: Optional[float] = None,
                 compression_target_sparsity: Optional[float] = None,
                 compression_hosts=None):
        from deeplearning4j_tpu_torch.parallel import compression as _comp

        self.model = model
        if getattr(model, "device", None) is None:
            raise ValueError("model must be init()ed first")
        if mesh is None:
            if workers is not None and int(workers) > 1:
                raise multi_device_error(f"ParallelWrapper(workers={workers})")
            mesh = TrainingMesh(data=1, devices=[model.device])
        if mesh.device != model.device:
            raise ValueError(f"mesh device {mesh.device} is not the model's "
                             f"({model.device})")
        self.mesh = mesh
        self.prefetch = prefetch
        self.skew_every = skew_every
        self.zero_optimizer = zero_optimizer
        self.deterministic = deterministic
        self.replicas = int(replicas if replicas is not None else mesh.data)
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if isinstance(grad_compression, _comp.GradCompressor):
            self._compressor = grad_compression
        else:
            scheme = _comp.resolve_scheme(grad_compression, model.conf)
            if scheme == "none":
                self._compressor = None
            else:
                knobs = model.conf.knobs
                hosts = compression_hosts
                if hosts in (None, "auto"):
                    hosts = self.mesh.dcn_hosts() if hosts == "auto" else 1
                self._compressor = _comp.GradCompressor(
                    scheme=scheme,
                    initial_threshold=(
                        compression_threshold
                        if compression_threshold is not None
                        else knobs.get("grad_compression_threshold", 1e-3)),
                    target_sparsity=(
                        compression_target_sparsity
                        if compression_target_sparsity is not None
                        else knobs.get("grad_compression_target", 1e-3)),
                    hosts=int(hosts))
        if self._compressor is not None:
            self._compressor.exchange_axis(self.replicas)  # fail fast
            engine = getattr(model, "_fused", None)
            if engine is not None and engine.loss_scale == "dynamic":
                raise ValueError(
                    "grad_compression with loss_scale='dynamic' is not "
                    "supported: the residual accumulates in scaled units, "
                    "so a scale change mid-run would silently re-weight the "
                    "carried error; use loss_scale='static' (the residual "
                    "then lives consistently in scaled units) or "
                    "compression 'none'")
        #: compression forces the lane step (per-worker gradients)
        self._uses_lanes = bool(deterministic or self._compressor)
        self._built = False
        self._programs: dict = {}
        self._tbptt_programs: dict = {}
        self._pool = None  # the graph pool of this wrapper's programs
        self._sizes_ref = None
        self._comp_state = None
        self._comp_stats = None
        self.layout: dict = {}

    # ---------------------------------------------------------------- build
    def _build(self):
        if not self.model.params:
            raise ValueError("model must be init()ed first")
        if self._compressor is not None:
            self._place_compression_state()
        self._publish_layout()
        self._built = True

    def _drop(self):
        self._programs, self._tbptt_programs = {}, {}
        self._pool = None

    # ------------------------------------------------- compression state
    def _comp_template(self):
        """ONE worker's gradient template: the fused engine's flat group
        buffers when the model fuses its update, the gradient tree
        otherwise (reference ``:214``)."""
        model = self.model
        engine = getattr(model, "_fused", None)
        if engine is not None:
            return [torch.zeros(g.total, dtype=torch.float32,
                                device=model.device) for g in engine.groups]
        return gspmd.grad_template(model)

    def _place_compression_state(self):
        """Adopt a restored state (checked against this wrapper's layout)
        or initialise the residual and threshold (reference ``:229``).
        Resident tensors are written in place, so programs built on them
        stay valid."""
        comp = self._compressor
        template = self._comp_template()
        prior = getattr(self.model, "_grad_comp_state", None)
        if prior is not None and not comp.state_matches(
                prior, template, self.replicas):
            raise ValueError(
                "restored grad-compression state does not match this "
                "wrapper's layout (scheme/replicas/hosts changed between "
                "runs?): clear model._grad_comp_state to reinitialize, "
                "losing the carried residual")
        fresh = comp.init_state(template, self.replicas)
        src = fresh if prior is None else tree_map(
            lambda f, v: (v if isinstance(v, torch.Tensor) else
                          torch.from_numpy(np.array(v, copy=True)))
            .to(device=f.device, dtype=f.dtype), fresh, prior)
        if self._comp_state is None:
            self._comp_state = tree_map(lambda v: v.clone(), src)
        else:
            with torch.no_grad():
                tree_copy_(self._comp_state, src)
        self.model._grad_comp_state = self._comp_state

    def _adopt_compression_state(self):
        """Re-adopt the model-side state when it was swapped from outside
        the step loop (reference ``:269``); free when nothing changed."""
        if self._compressor is None:
            return
        if getattr(self.model, "_grad_comp_state", None) is self._comp_state:
            return
        self._place_compression_state()

    # ------------------------------------------------------------ lane body
    @staticmethod
    def _lane_scale(loss_l, s_l, grads_l):
        """Lane weighting (reference ``:387``): each lane's loss and
        gradients times its loss-weight mass."""
        scaled = tree_map(
            lambda t: t * s_l.reshape(
                s_l.shape + (1,) * (t.dim() - 1)).to(t.dtype), grads_l)
        return loss_l * s_l, scaled

    def _update_engine(self):
        """The fused engine the lanes' gradients are flattened for (None:
        per-rule updaters)."""
        return getattr(self.model, "_fused", None)

    def _apply_combined(self, grads, flat: bool) -> None:
        """One update of the live state with the combined gradients (the
        fused engine's flat buffers when ``flat``)."""
        model = self.model
        sizes = model._sizes.views
        if flat:
            gspmd.apply_updaters_flat(model, model.params, grads,
                                      model.opt_states, sizes)
        else:
            gspmd.apply_updaters(model, model.params, grads,
                                 model.opt_states, sizes, scaled_grads=True)

    def _live_states(self):
        """The layer states the combined lane states are copied into."""
        return self.model.states

    def _combine_update(self, losses, wsums, states_l, grads_l):
        """Combine the lanes (weighted pairwise mean, or the compressed
        exchange) and apply one update, in place. Returns (loss, stats)."""
        loss_l, s_l = torch.stack(losses), torch.stack(wsums)
        comp = self._compressor
        engine = self._update_engine()
        total = gspmd.pairwise_sum(s_l)
        inv = 1.0 / torch.where(total == 0.0, torch.ones_like(total), total)
        stats = None
        if comp is not None and engine is not None:
            # the encode runs on the fused engine's flat buffers
            flat = gspmd.stack_lanes([engine.flatten_grads(g)
                                      for g in grads_l])
            loss_s, payload = self._lane_scale(loss_l, s_l, flat)
        else:
            loss_s, payload = self._lane_scale(
                loss_l, s_l, gspmd.stack_lanes(grads_l))
        if comp is not None:
            grads, new_comp, st = comp.encode_combine(
                payload, self._comp_state, inv)
            with torch.no_grad():
                tree_copy_(self._comp_state, new_comp)
            stats = torch.stack([st[k] for k in STATS])
        else:
            grads = tree_map(
                lambda t: gspmd.pairwise_sum(t) * inv.to(t.dtype), payload)
        loss = gspmd.pairwise_sum(loss_s) * inv
        new_states = gspmd.combine_states(gspmd.stack_lanes(states_l))
        self._apply_combined(grads, comp is not None and engine is not None)
        with torch.no_grad():
            tree_copy_(self._live_states(), new_states)
        return loss, stats

    def _lane_body(self, x, y, w, fm, lm):
        """One lane step (reference ``:420-453``): R lanes, combine,
        update; returns (loss, stats vector or None)."""
        model = self.model
        lane_vg = gspmd.make_lane_value_and_grad(model)
        losses, wsums, states_l, grads_l = [], [], [], []
        for r in range(self.replicas):
            (loss, ws), (ns, g) = lane_vg(
                model.params, model.states, _lane(x, r), _lane(y, r),
                w[r], _lane(fm, r), _lane(lm, r))
            losses.append(loss)
            wsums.append(ws)
            states_l.append(ns)
            grads_l.append(g)
        return self._combine_update(losses, wsums, states_l, grads_l)

    def _tbptt_body(self, carries_l, x, y, w, fm, lm):
        """One TBPTT segment's lane step (reference ``:455-484``): each
        lane on its own carries, which are updated in place."""
        model = self.model
        lane_vg = gspmd.make_lane_tbptt_value_and_grad(model)
        losses, wsums, states_l, grads_l, carries_new = [], [], [], [], []
        for r in range(self.replicas):
            (loss, ws), (ns, nc, g) = lane_vg(
                model.params, model.states, carries_l[r], x[r],
                _lane(y, r), w[r], _lane(fm, r), _lane(lm, r))
            losses.append(loss)
            wsums.append(ws)
            states_l.append(ns)
            grads_l.append(g)
            carries_new.append(nc)
        out = self._combine_update(losses, wsums, states_l, grads_l)
        with torch.no_grad():
            for dst, src in zip(carries_l, carries_new):
                tree_copy_(dst, src)
        return out

    def _state_trees(self):
        return [self.model.params, self.model.states, self.model.opt_states,
                self._comp_state]

    def _check_programs(self):
        """The programs read the network's step-size buffer: when the
        network dropped its programs (a rebind of its state), drop
        ours."""
        sizes = self.model._step_sizes()
        if sizes is not self._sizes_ref:
            self._drop()
            self._sizes_ref = sizes

    def _run(self, table, fn_name, body, args, trace_args=None):
        """One lane step through its program (or eagerly within
        ``capture.disabled()``); returns (loss, stats, program or None)."""
        if not capture.enabled():
            loss, stats = body(*args)
            return loss, stats, None
        prog = lane_program(self.model, table, capture.dispatch_sig(*args),
                            fn_name, body, args, self._state_trees(),
                            trace_args, owner=self)
        loss, stats = prog(*args)
        return loss.clone(), None if stats is None else stats.clone(), prog

    # ---------------------------------------------------------------- steps
    def step_batch(self, ds):
        """ONE train step on a DataSet (listeners included); returns the
        loss as a device tensor (reference ``:492``)."""
        if not self._built:
            self._build()
        self._adopt_compression_state()
        model = self.model
        if not self._uses_lanes:
            return self._fast_step(ds)
        feats, labs = ds.features, ds.labels
        if (getattr(model.conf, "tbptt_length", None)
                and not gspmd.is_graph(model)
                and _ndim(feats) == 3 and _ndim(labs) == 3
                and tuple(feats.shape)[1] > model.conf.tbptt_length):
            return self._step_batch_tbptt(ds)
        fm, lm = _batch_masks(ds, model)
        x, y, w, (fm, lm) = self.mesh.pad_lane_batch(
            feats, labs, self.replicas, extras=(fm, lm))
        fm, lm = _float_masks(fm), _float_masks(lm)
        self._check_programs()
        t0 = time.time_ns()
        with tm.span("parallel.step", iteration=model.iteration,
                     replicas=self.replicas):
            loss, stats, _ = self._run(
                self._programs, "ParallelWrapper.lane_step",
                self._lane_body, (x, y, w, fm, lm))
        if stats is not None:
            self._comp_stats = stats
        model.score_value = loss
        model.iteration += 1
        tm.counter("train.steps_total", model="parallel")
        if (self.skew_every and tm.enabled()
                and model.iteration % self.skew_every == 0):
            self._probe_replica_skew(loss, t0)
            self._publish_compression_stats()
        model._dispatcher.iteration_done(loss, model.iteration, model.epoch)
        return loss

    def _fast_step(self, ds):
        """The network's own weighted step on the batch (reference
        ``:280``): one device needs no padding, so this is ``fit``'s
        step."""
        model = self.model
        fm, lm = _batch_masks(ds, model)
        with tm.span("parallel.step", iteration=model.iteration,
                     replicas=self.mesh.data):
            model._fit_batch(ds.features, ds.labels, fm, lm)
        return model.score_value

    def _step_batch_tbptt(self, ds):
        """The segment loop of ``doTruncatedBPTT`` with every segment one
        lane step (reference ``:531-571``): carries lane-stacked across
        segments, gradients truncated at segment boundaries, one update a
        segment."""
        model = self.model
        k = model.conf.tbptt_length
        R = self.replicas
        fm, lm = _batch_masks(ds, model)
        x, y, w, (fm, lm) = self.mesh.pad_lane_batch(
            ds.features, ds.labels, R, extras=(fm, lm))
        fm, lm = _float_masks(fm), _float_masks(lm)
        b = x.shape[1]
        dtype = model._cast(x).dtype
        carries = [model._init_carries(b, dtype) for _ in range(R)]
        T = x.shape[2]
        losses = []

        def seg(a, s):
            return None if a is None else a[:, :, s:s + k].contiguous()

        for s in range(0, T, k):
            xs, ms, lms = seg(x, s), seg(fm, s), seg(lm, s)
            ys = seg(y, s) if y.dim() == 4 else y
            self._check_programs()
            args = (carries, xs, ys, w, ms, lms)
            with tm.span("parallel.tbptt_step", iteration=model.iteration,
                         segment_start=s):
                loss, stats, prog = self._run(
                    self._tbptt_programs, "ParallelWrapper.tbptt_step",
                    self._tbptt_body, args, trace_args=args[1:])
            if prog is not None:
                carries = prog.inputs[0]
            if stats is not None:
                self._comp_stats = stats
            model.iteration += 1
            losses.append(loss)
        model._dispatcher.flush()
        model.score_value = torch.stack(losses).mean()
        tm.counter("train.steps_total", model="parallel")
        for lst in model.listeners:
            lst.iteration_done(model, model.iteration, model.epoch)
        return model.score_value

    def end_epoch(self):
        """The tail of one fit() epoch (reference ``:573``): the window
        flushed, the epoch counter, ``on_epoch_end``."""
        self.model._end_epoch()

    def fit(self, iterator, epochs: int = 1):
        """fit(iterable of DataSet) | fit(DataSet) | fit(x, y) per epoch."""
        if not self._built:
            self._build()
        if isinstance(iterator, DataSet):
            iterator = [iterator]
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                self.step_batch(ds)
            self.end_epoch()
        return self.model

    # --------------------------------------------------- compression stats
    def compression_stats(self) -> Optional[dict]:
        """The latest step's wire accounting as floats (one host sync),
        also pushed to the ``parallel.allreduce_*`` gauges (reference
        ``:599``). None when compression is off or no step ran yet."""
        if self._comp_stats is None:
            return None
        vals = self._comp_stats.tolist()
        stats = dict(zip(STATS, vals))
        stats["threshold"] = float(self._comp_state["threshold"])
        if tm.enabled():
            tm.gauge("parallel.allreduce_wire_bytes", stats["wire_bytes"])
            tm.gauge("parallel.allreduce_dense_bytes", stats["dense_bytes"])
            tm.gauge("parallel.allreduce_compression_ratio", stats["ratio"])
            tm.counter("parallel.allreduce_wire_bytes_total",
                       value=stats["wire_bytes"])
            tm.counter("parallel.allreduce_exchanges_total")
        return stats

    def _publish_compression_stats(self):
        if self._comp_stats is not None and tm.enabled():
            self.compression_stats()

    # ------------------------------------------------------- layout plumbing
    def _publish_mesh_gauges(self):
        for axis in TrainingMesh.AXES:
            tm.gauge("parallel.mesh_axis_size", getattr(self.mesh, axis),
                     axis=axis)

    def _publish_layout(self):
        """The layout gauges and the per-leaf layout table (reference
        ``:636``)."""
        self._publish_mesh_gauges()
        tm.gauge("parallel.zero_state_sharded_fraction", 0.0)
        tm.gauge("parallel.opt_state_bytes_per_device",
                 self.opt_state_bytes_per_device())
        comp = self._compressor
        self.layout = {
            "signature": self.mesh.layout_signature(
                extra=(self.zero_optimizer, self.deterministic,
                       self.replicas,
                       (comp.scheme, comp.hosts) if comp else None)),
            "params": gspmd.describe_shardings(self.model.params),
            "opt_states": gspmd.describe_shardings(self.model.opt_states),
        }
        if comp is not None:
            tm.gauge("parallel.grad_compression_hosts", comp.hosts)
            self.layout["grad_compression"] = {
                "scheme": comp.scheme, "hosts": comp.hosts,
                "residual": gspmd.describe_shardings(
                    self._comp_state["residual"])}

    def opt_state_bytes_per_device(self) -> int:
        """Bytes of optimizer state the device holds (reference ``:662``):
        all of it on one device."""
        return gspmd.tree_bytes_per_device(self.model.opt_states)

    def reshard(self, mesh: Optional[TrainingMesh] = None):
        """Re-place the model's state on ``mesh`` and rebuild the steps
        (reference ``:667``). One-device meshes on the model's device: the
        lane count is fixed, so the residual and threshold carry over bit
        for bit and the fit continues its trajectory."""
        if mesh is None:
            mesh = TrainingMesh(data=1, devices=[self.model.device])
        if mesh.device != self.model.device:
            raise ValueError(f"reshard to {mesh.device}: the port keeps a "
                             f"network on its device ({self.model.device})")
        if self.deterministic and (mesh.model != 1 or mesh.seq != 1
                                   or mesh.pipe != 1):
            raise ValueError("deterministic lane mode needs a data-only mesh")
        self.mesh = mesh
        self._drop()
        self._build()
        tm.counter("parallel.reshards_total")
        return self

    # --------------------------------------------------------- cost report
    def cost_report(self, batch_size=None, *, shape=None,
                    dtype=torch.float32, name: str = "parallel",
                    publish: bool = True):
        """Per-layer cost table of ONE step (reference ``:714``, ``:791``):
        the fast step's is the network's own ``cost_report``; the lane
        step's counts lanes, combine (and encode) and update in one eager
        step on copies of the state. ``devices`` is 1."""
        from deeplearning4j_tpu_torch.util import cost_model as _cm

        model = self.model
        if not self._built:
            self._build()
        if shape is None:
            in_shape = getattr(model.conf, "input_shape", None)
            if in_shape is None:
                raise ValueError("cost_report() needs shape= or "
                                 "conf.input_shape")
            shape = (int(batch_size or 8 * self.replicas),) + tuple(in_shape)
        shape = tuple(int(d) for d in shape)
        b = shape[0]
        if not self._uses_lanes:
            rep = model.cost_report(shape=shape, dtype=dtype, name=name,
                                    publish=False)
            rep.devices = self.mesh.n_devices
            if publish:
                _cm.publish_report(str(name), rep)
            return rep
        if b % self.replicas:
            raise ValueError(f"global batch {b} must divide the lane count "
                             f"({self.replicas})")
        shadow = model._cost_shadow()
        twin = ParallelWrapper(
            shadow, mesh=self.mesh, deterministic=self.deterministic,
            replicas=self.replicas, grad_compression=self._compressor,
            skew_every=0)
        if self._comp_state is not None:
            shadow._grad_comp_state = tree_map(lambda v: v.clone(),
                                               self._comp_state)
        twin._build()
        out_shape = (b,) + tuple(getattr(model, "_output_shape", ()) or ())
        (x,), (y,) = _cm.random_batch(model.device, [shape], [out_shape],
                                      dtype)
        x, y, w = self.mesh.pad_lane_batch(x, y, self.replicas)
        params_by_tag = {}
        tags = getattr(model, "_layer_tags", None)
        if tags is not None:
            params_by_tag = {t: int(sum(v.numel() for v in tree_leaves(p)))
                             for t, p in zip(tags, model.params)}
        else:
            params_by_tag = {
                model._node_tags[k]: int(sum(v.numel()
                                             for v in tree_leaves(p)))
                for k, p in model.params.items()}
        with capture.disabled():
            shadow._step_sizes()
            rec = _cm.count_step(
                lambda: twin._lane_body(x, y, w, None, None))
        rows = _cm.rows_from_counts(rec.by_key, params_by_tag)
        report = _cm.CostReport(
            rows=rows, totals={
                "flops": sum(r.flops for r in rows),
                "transcendentals": sum(r.transcendentals for r in rows),
                "bytes_accessed": sum(r.bytes_accessed for r in rows)},
            batch=b, params_total=model.num_params(), source="counted",
            model=str(name),
            peak_flops=_cm.peak_flops_from_env(
                getattr(model.conf, "compute_dtype", None)),
            uncounted_ops=dict(rec.uncounted), kernels=dict(rec.kernels),
            devices=self.mesh.n_devices)
        if publish:
            _cm.publish_report(str(name), report)
        return report

    def _probe_replica_skew(self, loss, dispatch_t0_ns: int):
        """When each shard's loss became ready (reference ``:897``): one
        ``parallel.replica_step`` event per shard and the spread as
        ``parallel.straggler_skew_seconds``. One device holds one shard,
        so the spread is 0."""
        if loss.device.type == "cuda":
            torch.cuda.synchronize(loss.device)
        done = time.time_ns()
        tm.get_telemetry().event("parallel.replica_step", dispatch_t0_ns,
                                 done, tid=10_000,
                                 tname=f"replica 0 ({loss.device})",
                                 replica=0)
        tm.gauge("parallel.straggler_skew_seconds", 0.0)
        tm.gauge("parallel.replicas", self.mesh.n_devices)

    def average_model(self):
        """API parity: one update per step keeps every lane on the same
        params."""
        return self.model

    def warmup(self, batch_sizes, input_shape=None, label_shape=None) -> int:
        """Build the step's program for each GLOBAL batch size before the
        first real batch (reference ``:944``). A program's capture runs its
        body on the real state and puts back every tensor it touched (the
        params, moments, layer states, the residual and threshold, the
        dropout generator), so nothing moves. Returns the number of
        programs built (none within ``capture.disabled()``)."""
        if not self._built:
            self._build()
        model = self.model
        in_shape = tuple(input_shape or model.conf.input_shape or ())
        if not in_shape:
            raise ValueError("warmup() needs input_shape (or "
                             "conf.input_shape)")
        out_shape = tuple(label_shape
                          or getattr(model, "_output_shape", None) or ())
        if not out_shape:
            raise ValueError("warmup() needs label_shape")
        if not capture.enabled():
            return 0
        if not self._uses_lanes:
            return model.warmup(shapes=[(int(b),) + in_shape
                                        for b in batch_sizes],
                                train=True, inference=False)
        primed = 0
        for b in batch_sizes:
            x = torch.zeros((int(b),) + in_shape, device=model.device)
            y = torch.zeros((int(b),) + out_shape, device=model.device)
            x, y, w = self.mesh.pad_lane_batch(x, y, self.replicas)
            args = (x, y, w, None, None)
            self._check_programs()
            key = capture.dispatch_sig(*args)
            if key in self._programs:
                continue
            lane_program(model, self._programs, key,
                         "ParallelWrapper.lane_step", self._lane_body, args,
                         self._state_trees(), owner=self)
            primed += 1
        return primed


class ParallelInference:
    """Throughput serving over the mesh (ParallelInference parity, see the
    module doc). ``output`` takes any batch size: one bucket plan for every
    request size, chunks through the network's forward."""

    def __init__(self, model, mesh: Optional[TrainingMesh] = None,
                 batch_limit: int = 1024, batch_timeout_ms: float = 3.0,
                 queue_limit: int = 256, bucketing=None):
        from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy

        self.model = model
        if getattr(model, "device", None) is None:
            raise ValueError("model must be init()ed first")
        self.mesh = mesh or TrainingMesh(data=1, devices=[model.device])
        self.batch_limit = batch_limit
        self.batch_timeout_ms = batch_timeout_ms
        if bucketing is None:
            bucketing = BucketingPolicy.from_conf(
                getattr(model, "conf", None))
        elif bucketing is False:
            bucketing = None
        elif isinstance(bucketing, str):
            bucketing = BucketingPolicy.from_spec(bucketing)
        self.bucketing = bucketing
        self._queue: "queue.Queue[Tuple[np.ndarray, Future]]" = queue.Queue(
            maxsize=queue_limit)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._stop = threading.Event()
        self._shut_down = False
        #: device calls made (one a planned chunk)
        self.chunks_executed = 0
        #: coalesced batches the ``output_async`` worker ran
        self.batches_executed = 0

    def output(self, x):
        """Predictions for ``x`` (any batch size) as float32 numpy."""
        x = np.asarray(x)
        n = len(x)
        if self.bucketing is not None:
            plan = self.bucketing.plan_serving_batch(n, cap=self.batch_limit)
            if len(plan) > 1:
                chunks, off = [], 0
                for take, padded in plan:
                    chunks.append(self._output_one(x[off:off + take],
                                                   padded))
                    off += take
                return np.concatenate(chunks, axis=0)
            return self._output_one(x, plan[0][1])
        if n > self.batch_limit:
            return np.concatenate([
                self._output_one(x[i:i + self.batch_limit])
                for i in range(0, n, self.batch_limit)], axis=0)
        return self._output_one(x)

    def _output_one(self, x, target=None):
        """One device call, padded to ``target`` rows by repeating the last
        row (the plan's padded size; without a plan, the bucket)."""
        n = len(x)
        d = self.mesh.data
        if target is None:
            target = (n if self.bucketing is None
                      else self.bucketing.bucket_batch(n))
        target += (d - target % d) % d
        pad = target - n
        if pad:
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
        out = self.model.output(as_tensor(x, self.model.device))
        self.chunks_executed += 1
        return out.to(torch.float32).cpu().numpy()[:n]

    def warmup(self, batch_sizes=None, input_shape=None) -> int:
        """Build the forward of every bucket before traffic (reference
        ``:1105``): one zero batch a size. ``batch_sizes`` defaults to the
        policy's explicit ``batch_buckets``. Returns the sizes primed."""
        if batch_sizes is None:
            if (self.bucketing is None
                    or not isinstance(self.bucketing.batch_buckets, tuple)):
                raise ValueError(
                    "warmup() without batch_sizes needs an explicit "
                    "batch_buckets bucketing policy")
            batch_sizes = self.bucketing.batch_buckets
        conf = getattr(self.model, "conf", None)
        shape = tuple(input_shape
                      or getattr(conf, "input_shape", None)
                      or (getattr(conf, "input_shapes", None) or [()])[0])
        if not shape:
            raise ValueError("warmup() needs input_shape (or "
                             "conf.input_shape)")
        primed = 0
        for b in batch_sizes:
            self.output(np.zeros((int(b),) + shape, np.float32))
            primed += 1
        return primed

    # ----------------------------------------------------- dynamic batching
    def output_async(self, x) -> "Future":
        """Queue a request; a worker thread coalesces pending requests into
        one device batch (reference ``:1133``). Returns a Future."""
        with self._worker_lock:
            if self._shut_down:
                raise RuntimeError("ParallelInference shut down")
            if self._worker is None:
                self._start_worker()
            fut: Future = Future()
            self._queue.put((np.asarray(x), fut))
        return fut

    @staticmethod
    def _resolve(fut: Future, value=None, exc=None):
        if not fut.set_running_or_notify_cancel():
            return  # cancelled before the worker got to it
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)

    def _start_worker(self):
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                batch: List[Tuple[np.ndarray, Future]] = [first]
                total = len(first[0])
                deadline = self.batch_timeout_ms / 1e3
                t0 = time.monotonic()
                while total < self.batch_limit:
                    remaining = deadline - (time.monotonic() - t0)
                    if remaining <= 0:
                        break
                    try:
                        item = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    batch.append(item)
                    total += len(item[0])
                # a bad request (wrong rank or width) fails its batch,
                # never the worker
                try:
                    xs = np.concatenate([b[0] for b in batch], axis=0)
                    self.batches_executed += 1
                    preds = self.output(xs)
                    off = 0
                    for arr, fut in batch:
                        self._resolve(fut, value=preds[off:off + len(arr)])
                        off += len(arr)
                except Exception as e:  # noqa: BLE001 - failed to callers
                    for _, fut in batch:
                        if not fut.done():
                            self._resolve(fut, exc=e)

        self._worker = threading.Thread(target=run, daemon=True,
                                        name="dl4j-torch-parallel-inference")
        self._worker.start()

    def shutdown(self):
        """Stop the batching worker (failing queued requests); later
        ``output_async`` calls raise."""
        with self._worker_lock:
            self._shut_down = True
            self._stop.set()
            worker = self._worker
            self._worker = None
        if worker is not None:
            worker.join(timeout=2.0)
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                self._resolve(fut, exc=RuntimeError(
                    "ParallelInference shut down"))
