"""MultiLayerNetwork — the linear layer stack (counterpart of
deeplearning4j_tpu/nn/multilayer.py): inference, training with truncated
BPTT, and stateful step-by-step inference.

The configuration is ``nn/conf.py``'s :class:`MultiLayerConfiguration`
(built by ``NeuralNetConfiguration.builder().list()``, JSON shared with the
reference). The runtime runs the layers in order eagerly, each layer's
``apply`` on the previous output, inside the conf's kernel-dispatch scope.

- ``init(device=)`` (reference ``:151``) draws every layer's params from
  one ``torch.Generator`` seeded with ``conf.seed``, in layer order, and
  places them on ``device``: CUDA unless the caller names another. It also
  makes the optimizer states and the dropout generator (seeded from
  ``conf.seed`` on ``device``).
- ``compute_dtype="bfloat16"`` casts a floating input and the params to
  bf16 for the forward (``_cast``/``_cast_params``, ``:195-206``); integer
  inputs (token ids) stay as they are. Inference caches the bf16 copies
  per param version; training casts inside autograd, so the gradients
  reach the fp32 params.
- Masks (``:214-235``): the (B, T) feature mask goes to every layer whose
  ``apply`` takes one while the activations are (B, T, ...), and is
  dropped once a layer has consumed the time axis; in training the label
  mask (else the feature mask) gates the loss.
- Batch bucketing (``batch_buckets``, ``seq_buckets``) pads a batch up to
  its bucket: inference slices the padding rows off the result, training
  keeps them out of the loss with 0/1 row weights (passed on every batch,
  ones when nothing was padded).

Training (``fit`` ``:444``, ``_fit_batch`` ``:632``): one eager step is the
training forward with dropout, the output layer's loss plus the layers'
l1/l2 penalty (``_loss_body_impl`` ``:249-301``), ``torch.autograd.grad``
with respect to the params, and each layer's updater (its own, else the
conf's, else Sgd(0.1)), applied in place. With ``tbptt_length`` k and a
sequence longer than k with per-step labels (``_fit_batch_tbptt``
``:529``), the time axis is cut into k-step segments: each segment is one
update (and one iteration), the recurrent carries flow from one segment to
the next, and the carry entering a segment is detached, so gradients stop
at segment boundaries. Carries live in the compute type.
``rnn_time_step`` (``:591``) runs the stack on one step or a few, keeping
the recurrent carries between calls until ``rnn_clear_previous_state``.

Scoring and evaluation (``score`` ``:975``, ``evaluate`` ``:1008``,
``evaluate_regression`` ``:1021``): ``score`` is the inference-mode loss of
a batch, masks and bucketing as in training, with the layers' l1/l2
penalty, as the reference's ``_loss_eval`` has it; ``evaluate`` runs
``output`` over an iterator into an ``Evaluation`` (or a
``RegressionEvaluation``), which copies each batch's predictions to the
host once.

Listeners (``set_listeners``/``add_listener``, ``nn/listeners.py``): every
update calls them through the coalescing dispatcher, whose window is the
conf's ``sync_every`` (1: at once; n: one host copy of n losses); a TBPTT
batch calls them once, after its last segment, as the reference does
(``:584-587``); the end of each epoch flushes the window, then calls
``on_epoch_end``.

Refused: ``fused_update``/``loss_scale`` (ROADMAP.md Queue 1 item 10).
Layers wrapped in ``nn/transfer.py``'s ``FrozenLayer`` take no gradient:
their params enter the updater with zero gradients, which leave Adam's
update exactly zero, as in the reference. Not ported:
telemetry, the AOT store (item 12) and ``pretrain`` (item 13); remat
stages are kept as config.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.data.bucketing import (BucketingPolicy,
                                                     dev_weights)
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.device import as_tensor, resolve_device
from deeplearning4j_tpu_torch.eval import Evaluation, RegressionEvaluation
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.conf import (DEFAULT_UPDATER, INERT_KNOBS,
                                              MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.listeners import CoalescingListenerDispatcher
from deeplearning4j_tpu_torch.nn.recurrent import Bidirectional, is_recurrent
from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.tree import (tree_items, tree_leaves, tree_map,
                                           tree_set)


class MultiLayerNetwork:
    """Layer-stack runtime (MultiLayerNetwork.java parity). ``params``,
    ``states`` and ``opt_states`` are lists with one entry per layer, keyed
    as the reference keys them; params are plain tensors, marked as needing
    a gradient only inside a training step."""

    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers = conf.layers
        self.params: List[dict] = []
        self.states: List[dict] = []
        self.opt_states: List[Any] = []
        self.iteration = 0
        self.epoch = 0
        self.listeners: list = []
        self.score_value: Any = float("nan")
        self.last_iteration_wall_ns = None  # set during coalesced dispatch
        self._dispatcher = CoalescingListenerDispatcher(
            self, {**INERT_KNOBS, **conf.knobs}["sync_every"])
        self.device: Optional[torch.device] = None
        self._gen: Optional[torch.Generator] = None  # dropout, set by init
        self._rnn_carries: Optional[list] = None
        self._cast_cache: Dict[Tuple[int, str], tuple] = {}
        self._w_cache: dict = {}
        # per-layer updater (:74-76); layers with equal updaters step together
        self._updaters = [
            upd.updater_from_dict(lyr.updater or conf.updater
                                  or DEFAULT_UPDATER)
            for lyr in self.layers]
        self._update_groups = upd.group_by_rule(dict(enumerate(
            self._updaters)))
        # which layers' apply()/compute_loss() take a mask
        # (setLayerMaskArrays parity)
        self._mask_aware = [
            "mask" in inspect.signature(lyr.apply).parameters
            for lyr in self.layers]
        last = self.layers[-1]
        self._loss_mask_aware = hasattr(last, "compute_loss") and (
            "mask" in inspect.signature(last.compute_loss).parameters)
        self._bucketing = BucketingPolicy.from_conf(conf)

    # ------------------------------------------------------------------ init
    def init(self, input_shape=None, device=None) -> "MultiLayerNetwork":
        """Initialize params/states from a ``torch.Generator`` seeded with
        ``conf.seed`` on ``device`` (CUDA unless named otherwise), the
        optimizer states, and the dropout generator."""
        shape = tuple(input_shape or self.conf.input_shape or ())
        if not shape:
            raise ValueError(
                "input_shape required (set_input_type on the builder)")
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        self.params, self.states = [], []
        cur = shape
        for lyr in self.layers:
            p, s = lyr.initialize(gen, cur)
            self.params.append(tree_map(lambda v: v.to(self.device), p))
            self.states.append(tree_map(lambda v: v.to(self.device), s))
            cur = lyr.output_shape(cur)
        self.opt_states = [u.init_state(p)
                           for u, p in zip(self._updaters, self.params)]
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(self.conf.seed))
        self._rnn_carries = None
        self._cast_cache = {}
        return self

    def num_params(self) -> int:
        return sum(int(t.numel()) for t in tree_leaves(self.params))

    def _require_init(self):
        if self.device is None:
            raise ValueError("init() the network first")

    # --------------------------------------------------------------- forward
    def _kscope(self):
        """Kernel-dispatch scope for this net's layers (ops/kernels)."""
        return _kern.impl_scope(self.conf.kernel_impl)

    def _cast(self, x):
        if self.conf.compute_dtype == "bfloat16" and x.is_floating_point():
            return x.to(torch.bfloat16)
        return x

    def _cast_params(self, params):
        """bf16 copies of the params, made once per param tensor and reused
        while the source is the same tensor at the same version."""
        if self.conf.compute_dtype != "bfloat16":
            return params
        out = []
        for i, p in enumerate(params):
            layer = {}
            for path, v in tree_items(p):
                hit = self._cast_cache.get((i, path))
                if hit is None or hit[0] is not v or hit[1] != v._version:
                    hit = (v, v._version, self._cast(v))
                    self._cast_cache[(i, path)] = hit
                tree_set(layer, path, hit[2])
            out.append(layer)
        return out

    def _forward_body(self, params, states, x, *, training, mask=None):
        h = self._cast(x)
        cparams = self._cast_params(params)
        for i, lyr in enumerate(self.layers):
            kw = {}
            if (mask is not None and self._mask_aware[i] and h.dim() == 3
                    and tuple(mask.shape[:2]) == tuple(h.shape[:2])):
                kw["mask"] = mask
            h, _ = lyr.apply(cparams[i], states[i], h, training=training,
                             **kw)
            if h.dim() < 3:
                mask = None  # time axis consumed (TimeStep/GlobalPooling)
        return h

    def _forward(self, x, *, training=False, mask=None):
        with self._kscope(), torch.inference_mode():
            return self._forward_body(self.params, self.states, x,
                                      training=training, mask=mask)

    # ---------------------------------------------------------------- output
    def output(self, x, train: bool = False, mask=None):
        """Forward pass (MultiLayerNetwork.output parity): the output
        layer's activation, i.e. probabilities. ``train=True`` uses
        training-mode statistics and no dropout. ``mask``: (B, T) feature
        mask, 1 = real. Under ``batch_buckets`` an unmasked batch pads up
        to its bucket and the padding rows are sliced off."""
        self._require_init()
        x = as_tensor(x, self.device)
        mk = None if mask is None else as_tensor(mask, self.device)
        real_n = None
        if self._bucketing is not None and mk is None:
            size = self._bucketing.bucket_batch(x.shape[0])
            if size != x.shape[0]:
                real_n = x.shape[0]
                x = BucketingPolicy._pad_axis(x, 0, size)
        out = self._forward(x, training=train, mask=mk)
        return out if real_n is None else out[:real_n]

    def feed_forward(self, x) -> List[torch.Tensor]:
        """Per-layer activations, the (cast) input first
        (MultiLayerNetwork.feedForward parity)."""
        self._require_init()
        with self._kscope(), torch.inference_mode():
            h = self._cast(as_tensor(x, self.device))
            cparams = self._cast_params(self.params)
            acts = [h]
            for i, lyr in enumerate(self.layers):
                h, _ = lyr.apply(cparams[i], self.states[i], h,
                                 training=False)
                acts.append(h)
        return acts

    # ------------------------------------------------------------------ loss
    def _loss_body(self, carries, x, y, weights, mask, label_mask, *,
                   training=True):
        """The forward + loss (``_loss_body_impl`` ``:249-301``): ``carries``
        None for the whole-sequence step, else one carry per layer
        (recurrent layers run ``apply_seq`` on it, after their input
        dropout). Returns (loss + penalty in fp32, (new states, new
        carries)). Training casts the params inside autograd and draws
        dropout from the net's generator."""
        gen = self._gen if training else None
        h = self._cast(x)
        if training:
            cparams = [tree_map(self._cast, p) for p in self.params]
        else:
            cparams = self._cast_params(self.params)
        new_states, new_carries = [], []
        fmask = mask
        for i, lyr in enumerate(self.layers[:-1]):
            seg_mask = (fmask if (fmask is not None and h.dim() == 3
                                  and tuple(fmask.shape[:2])
                                  == tuple(h.shape[:2])) else None)
            if carries is not None and is_recurrent(lyr):
                h = lyr._maybe_dropout(h, training, gen)
                h, c = lyr.apply_seq(cparams[i], h, carries[i],
                                     mask=seg_mask, training=training)
                new_carries.append(c)
                new_states.append(self.states[i])
            else:
                kw = {}
                if seg_mask is not None and self._mask_aware[i]:
                    kw["mask"] = seg_mask
                h, ns = lyr.apply(cparams[i], self.states[i], h,
                                  training=training, gen=gen, **kw)
                new_states.append(ns)
                new_carries.append(None if carries is None else carries[i])
            if h.dim() < 3:
                fmask = None
        out = self.layers[-1]
        if not hasattr(out, "compute_loss"):
            raise ValueError("last layer must be an OutputLayer/LossLayer")
        loss_kw = {}
        lm = label_mask if label_mask is not None else fmask
        if lm is not None and self._loss_mask_aware:
            loss_kw["mask"] = lm
        if weights is not None:
            loss_kw["weights"] = weights
        loss = out.compute_loss(cparams[-1], self.states[-1], h, y,
                                training=training, gen=gen, **loss_kw)
        new_states.append(self.states[-1])
        new_carries.append(None if carries is None else carries[-1])
        loss = loss.to(torch.promote_types(loss.dtype, torch.float32))
        for i, lyr in enumerate(self.layers):
            loss = loss + lyr.regularization(self.params[i])
        return loss, (new_states, new_carries)

    # ---------------------------------------------------------------- train
    def _check_trainable(self):
        self._require_init()
        k = {**INERT_KNOBS, **self.conf.knobs}
        if k["fused_update"] or k["loss_scale"] != "none":
            raise NotImplementedError(
                "fused_update / loss_scale are not ported yet: the fused "
                "optimizer (FusedUpdateEngine) and loss scaling come with the "
                "parallel-training slice (ROADMAP Queue 1 item 10)")

    def _gradients(self, carries, x, y, weights, mask=None, label_mask=None):
        """(loss, grads, new states, new carries) of one training forward
        and backward, leaving params and optimizer states as they are.
        ``grads`` is {layer index: {key: tensor}}; layers whose updater is
        NoOp are frozen and get none. The new states and carries come back
        detached: a carry handed to the next segment starts a new graph."""
        leaves = [(i, path, t) for i, u in enumerate(self._updaters)
                  if not isinstance(u, upd.NoOp)
                  for path, t in tree_items(self.params[i])
                  if t.is_floating_point()]
        for _, _, t in leaves:
            t.requires_grad_(True)
        try:
            with self._kscope():
                loss, (new_states, new_carries) = self._loss_body(
                    carries, x, y, weights, mask, label_mask)
                gs = torch.autograd.grad(loss, [t for _, _, t in leaves],
                                         allow_unused=True)
        finally:
            for _, _, t in leaves:
                t.requires_grad_(False)
        grads: Dict[int, dict] = {}
        for (i, path, t), g in zip(leaves, gs):
            tree_set(grads.setdefault(i, {}), path,
                     torch.zeros_like(t) if g is None else g)
        detach = lambda v: v.detach()  # noqa: E731
        new_states = [tree_map(detach, s) for s in new_states]
        new_carries = [tree_map(detach, c) for c in new_carries]
        return loss.detach(), grads, new_states, new_carries

    def _apply_step(self, grads, new_states):
        upd.step_groups(self._update_groups, self.params, grads,
                        self.opt_states, self.iteration)
        self.states = new_states
        self.iteration += 1

    def fit(self, data, labels=None, epochs: int = 1):
        """fit(x, y) | fit(DataSet) | fit(iterable of DataSet), each
        ``epochs`` times (``:444``); a DataSet's feature and label masks
        are applied."""
        if labels is not None:
            for _ in range(epochs):
                self._fit_batch(data, labels)
                self._end_epoch()
            return self
        if isinstance(data, DataSet):
            data = [data]
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            for ds in data:
                self._fit_batch(ds.features, ds.labels,
                                mask=getattr(ds, "features_mask", None),
                                label_mask=getattr(ds, "labels_mask", None))
            self._end_epoch()
        return self

    def _end_epoch(self):
        """``:469-474``: the listeners see the whole epoch before its end."""
        self._dispatcher.flush()
        self.epoch += 1
        for lst in self.listeners:
            if hasattr(lst, "on_epoch_end"):
                lst.on_epoch_end(self)

    def _on_device(self, x, y, mask, label_mask):
        """x, y and the (B, T) masks as tensors on this net's device, the
        masks as floats."""
        dev = self.device
        return (as_tensor(x, dev), as_tensor(y, dev),
                None if mask is None else as_tensor(mask, dev).float(),
                None if label_mask is None
                else as_tensor(label_mask, dev).float())

    def _fit_batch(self, x, y, mask=None, label_mask=None):
        """One update (``:632-705``), or one per TBPTT segment when
        ``tbptt_length`` cuts the sequence. ``score_value`` keeps the loss
        as a device tensor (no host sync per step); ``get_score()`` reads
        it. The listeners get the iteration through the dispatcher."""
        self._check_trainable()
        x, y, mask, label_mask = self._on_device(x, y, mask, label_mask)
        k = self.conf.tbptt_length
        if k and x.dim() == 3 and y.dim() == 3 and x.shape[1] > k:
            # per-sequence (2-D) labels cannot be segmented: whole-sequence
            # BPTT, as the reference's doTruncatedBPTT does
            return self._fit_batch_tbptt(x, y, mask, label_mask)
        real_n = x.shape[0]
        if self._bucketing is not None:
            x, y, mask, label_mask = self._bucketing.pad_batch(
                x, y, mask, label_mask)
        weights = dev_weights(self._w_cache, x.shape[0], real_n, self.device)
        loss, grads, new_states, _ = self._gradients(
            None, x, y, weights, mask, label_mask)
        self._apply_step(grads, new_states)
        self.score_value = loss
        self._dispatcher.iteration_done(loss, self.iteration, self.epoch)

    def _init_carries(self, batch_size, dtype):
        return [lyr.init_carry(batch_size, dtype, self.device)
                if is_recurrent(lyr) else None for lyr in self.layers]

    def _fit_batch_tbptt(self, x, y, mask=None, label_mask=None):
        """The segment loop (``:529-589``): each k-step segment is one
        update and one iteration, the carries flow forward detached, and
        ``score_value`` is the mean of the segments' losses; the listeners
        are called once, after the last segment (the window flushed
        first, as the reference does). Under
        bucketing the batch rows pad to their bucket once, and each segment
        pads onto the (B, k) shape (``pad_segment``)."""
        k = self.conf.tbptt_length
        real_n = x.shape[0]
        bucketing = self._bucketing
        if bucketing is not None:
            npad = bucketing.bucket_batch(real_n)
            if npad != real_n:
                x, y = (BucketingPolicy._pad_axis(a, 0, npad) for a in (x, y))
                mask, label_mask = (
                    None if m is None else BucketingPolicy._pad_axis(m, 0, npad)
                    for m in (mask, label_mask))
        weights = dev_weights(self._w_cache, x.shape[0], real_n, self.device)
        # carries in the compute type: an fp32 carry would promote the
        # recurrent products of a bf16 net
        carries = self._init_carries(x.shape[0], self._cast(x).dtype)
        losses = []
        for s in range(0, x.shape[1], k):
            xs = x[:, s:s + k]
            ys = y[:, s:s + k]
            ms = None if mask is None else mask[:, s:s + k]
            lms = None if label_mask is None else label_mask[:, s:s + k]
            if bucketing is not None:
                (xs, ys), ms, lms = bucketing.pad_segment((xs, ys), ms, lms, k)
            loss, grads, new_states, carries = self._gradients(
                carries, xs, ys, weights, ms, lms)
            self._apply_step(grads, new_states)
            losses.append(loss)
        self._dispatcher.flush()
        self.score_value = torch.stack(losses).mean()
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)

    # ------------------------------------------------- stateful rnn inference
    def rnn_time_step(self, x):
        """Stateful step-by-step inference (rnnTimeStep parity, ``:591``):
        the recurrent carries persist across calls. ``x`` is (B, T, F), or
        (B, F) for one step (the output then has no time axis). A batch
        size other than the carried one raises, and so does a
        Bidirectional layer, which needs the sequence's future (the
        reference's ``:594-600``)."""
        if any(isinstance(lyr, Bidirectional) for lyr in self.layers):
            raise ValueError(
                "rnn_time_step does not support Bidirectional layers")
        self._require_init()
        x = self._cast(as_tensor(x, self.device))
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None]
        carries = self._rnn_carries
        if carries is not None:
            for leaf in tree_leaves(carries):
                if leaf.shape[0] != x.shape[0]:
                    raise ValueError(
                        f"rnn_time_step batch size changed "
                        f"({leaf.shape[0]} -> {x.shape[0]}); call "
                        "rnn_clear_previous_state()")
        else:
            carries = self._init_carries(x.shape[0], x.dtype)
        new_carries = []
        with self._kscope(), torch.inference_mode():
            cparams = self._cast_params(self.params)
            h = x
            for i, lyr in enumerate(self.layers):
                if is_recurrent(lyr):
                    h, c = lyr.apply_seq(cparams[i], h, carries[i],
                                         training=False)
                    new_carries.append(c)
                else:
                    h, _ = lyr.apply(cparams[i], self.states[i], h,
                                     training=False)
                    new_carries.append(None)
        self._rnn_carries = new_carries
        return h[:, -1] if (squeeze and h.dim() == 3) else h

    def rnn_clear_previous_state(self):
        """rnnClearPreviousState parity (``:628``)."""
        self._rnn_carries = None

    def get_score(self) -> float:
        return float(self.score_value)

    # ------------------------------------------------------- score, evaluate
    def score(self, dataset=None, x=None, y=None, mask=None,
              label_mask=None) -> float:
        """The inference-mode loss of a batch with the layers' l1/l2
        penalty, as a float (``:975``, ``_loss_eval`` ``:994``): no
        dropout, the DataSet's feature and label masks applied, a batch
        padded to its bucket under ``batch_buckets`` with the padding rows
        weighted 0."""
        self._require_init()
        if dataset is not None:
            x, y = dataset.features, dataset.labels
            mask = getattr(dataset, "features_mask", None)
            label_mask = getattr(dataset, "labels_mask", None)
        x, y, mask, label_mask = self._on_device(x, y, mask, label_mask)
        real_n = x.shape[0]
        if self._bucketing is not None:
            x, y, mask, label_mask = self._bucketing.pad_batch(
                x, y, mask, label_mask)
        weights = dev_weights(self._w_cache, x.shape[0], real_n, self.device)
        with self._kscope(), torch.inference_mode():
            loss, _ = self._loss_body(None, x, y, weights, mask, label_mask,
                                      training=False)
        return float(loss)

    def _evaluate_into(self, ev, iterator):
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            preds = self.output(ds.features,
                                mask=getattr(ds, "features_mask", None))
            ev.eval(ds.labels, preds)
        return ev

    def evaluate(self, iterator) -> Evaluation:
        """Classification metrics of ``output`` over an iterator of
        DataSets (``:1008``)."""
        return self._evaluate_into(Evaluation(), iterator)

    def evaluate_regression(self, iterator) -> RegressionEvaluation:
        """Regression metrics of ``output`` over an iterator (``:1021``)."""
        return self._evaluate_into(RegressionEvaluation(), iterator)

    # -------------------------------------------------------------- listeners
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self
