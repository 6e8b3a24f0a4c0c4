"""MultiLayerNetwork — the linear layer stack (counterpart of
deeplearning4j_tpu/nn/multilayer.py): inference, training with truncated
BPTT, and stateful step-by-step inference.

The configuration is ``nn/conf.py``'s :class:`MultiLayerConfiguration`
(built by ``NeuralNetConfiguration.builder().list()``, JSON shared with the
reference). The runtime runs the layers in order, each layer's ``apply``
on the previous output, inside the conf's kernel-dispatch scope.

Compiled programs (``nn/capture.py``; the reference's jitted, donated
``_train_step`` ``:421-441``, ``_tbptt_step`` ``:478-521`` and
``_forward_jit`` ``:179-180``): ``fit``, the TBPTT loop and ``output``
dispatch on the batch's shape signature (``_dispatch_sig``, ``:46-52``) to
a program per signature, held in ``_aot_steps``, ``_tbptt_steps`` and
``_aot_forward``. On a CUDA net a program is a CUDA graph captured the
first time its signature comes, then replayed; on the CPU it runs the same
body on the same static buffers eagerly. Bucketing pads outside the
program. ``warmup`` (``:762-833``) builds the train and forward programs of
every bucket before traffic; ``capture.disabled()`` runs every step
eagerly, with no program. Rebinding the params, states or optimizer states
(``init``, ``interop``'s loaders, the transfer builder) drops the programs.

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

Training (``fit`` ``:444``, ``_fit_batch`` ``:632``): one step is the
training forward with dropout, the output layer's loss plus the layers'
l1/l2 penalty (``_loss_body_impl`` ``:249-301``), ``torch.autograd.grad``
with respect to the params, and each layer's updater (its own, else the
conf's, else Sgd(0.1)), applied in place with this iteration's step sizes
(``nn/updaters.py::StepSizes``), the new layer states copied into the
net's own tensors. With ``tbptt_length`` k and a
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
update exactly zero, as in the reference. Not ported: telemetry, the AOT
store and ``warmup``'s ``export_dir`` (item 12), ``pretrain`` (item 13);
``score`` and ``rnn_time_step`` run eagerly; remat stages are kept as
config.
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
from deeplearning4j_tpu_torch.nn import capture
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.conf import (DEFAULT_UPDATER, INERT_KNOBS,
                                              MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.listeners import CoalescingListenerDispatcher
from deeplearning4j_tpu_torch.nn.recurrent import Bidirectional, is_recurrent
from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.tree import (tree_copy_, tree_items,
                                           tree_leaves, tree_map, tree_set)

_dispatch_sig = capture.dispatch_sig


class MultiLayerNetwork(capture.CompiledSteps):
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
        self._output_shape: Optional[tuple] = None
        self._drop_programs()

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
        self._output_shape = tuple(cur)
        self.opt_states = [u.init_state(p)
                           for u, p in zip(self._updaters, self.params)]
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(self.conf.seed))
        self._rnn_carries = None
        self._cast_cache = {}
        self._drop_programs()
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

    def _forward_body(self, cparams, states, x, *, training, mask=None):
        """The layers on ``x`` with the (cast) params ``cparams``."""
        h = self._cast(x)
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
            return self._forward_body(self._cast_params(self.params),
                                      self.states, x, training=training,
                                      mask=mask)

    def _forward_program_body(self, training):
        """The forward a program captures: the params cast inside it (a
        replay after ``fit`` casts the updated params; the eager forward's
        cast cache decides on the host)."""
        def body(x, mask):
            with self._kscope(), torch.inference_mode():
                cparams = [tree_map(self._cast, p) for p in self.params]
                return self._forward_body(cparams, self.states, x,
                                          training=training, mask=mask)
        return body

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
        if capture.enabled():
            key = (bool(train), _dispatch_sig(x, mk))
            out = self._program(
                self._aot_forward, key, "MultiLayerNetwork.forward",
                self._forward_program_body(bool(train)), (x, mk),
                train=False)(x, mk).clone()
        else:
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

    def _train_body(self, x, y, weights, mask, label_mask):
        """One update, in place; returns the loss."""
        loss, grads, new_states, _ = self._gradients(
            None, x, y, weights, mask, label_mask)
        self._update(grads, new_states)
        return loss

    def _tbptt_body(self, carries, x, y, weights, mask, label_mask):
        """One segment's update, in place, the carries included; returns
        the loss."""
        loss, grads, new_states, new_carries = self._gradients(
            carries, x, y, weights, mask, label_mask)
        self._update(grads, new_states)
        tree_copy_(carries, new_carries)
        return loss

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
        self._step_sizes()
        args = (x, y, weights, mask, label_mask)
        if capture.enabled():
            loss, _ = self._replay_step(self._aot_steps,
                                        "MultiLayerNetwork.train_step",
                                        self._train_body, args)
        else:
            loss = self._train_body(*args)
        self.iteration += 1
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

        def seg(a, s):
            return None if a is None else a[:, s:s + k].contiguous()

        losses = []
        for s in range(0, x.shape[1], k):
            xs, ys, ms, lms = (seg(a, s) for a in (x, y, mask, label_mask))
            if bucketing is not None:
                (xs, ys), ms, lms = bucketing.pad_segment((xs, ys), ms, lms, k)
            self._step_sizes()
            args = (carries, xs, ys, weights, ms, lms)
            if capture.enabled():
                # the ragged last segment has a signature, and a program,
                # of its own; the carries flow through the programs'
                # static buffers, updated in place at each segment's end
                loss, prog = self._replay_step(
                    self._tbptt_steps, "MultiLayerNetwork.tbptt_step",
                    self._tbptt_body, args, trace_args=args[1:])
                carries = prog.inputs[0]
            else:
                loss = self._tbptt_body(*args)
            self.iteration += 1
            losses.append(loss)
        self._dispatcher.flush()
        self.score_value = torch.stack(losses).mean()
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)

    # ---------------------------------------------------------------- warmup
    def warmup(self, shapes=None, *, train=True, inference=True,
               dtype=torch.float32, export_dir=None) -> int:
        """Build the train step's and the inference forward's programs for
        every bucket before traffic (``:762-833``), so the first real batch
        of each replays a captured graph. ``shapes``: full input shapes
        with the batch, e.g. ``[(8, 28, 28, 1), (16, 28, 28, 1)]``;
        default the conf's explicit ``batch_buckets`` x its
        ``input_shape``. The train program's signature is the one ``fit``
        gives an unmasked batch (fp32 labels of the output's shape, the row
        weights); the forward's, ``output``'s without a mask. Programs
        already built are kept. Returns the number built (none within
        ``capture.disabled()``).

        ``export_dir`` (the reference's on-disk AOT store) raises: a CUDA
        graph holds one process's device addresses, so storing programs
        waits for ROADMAP Queue 1 item 12."""
        if export_dir is not None:
            raise NotImplementedError(
                "warmup(export_dir=...) is not ported: the AOT store "
                "(util/aot_store.py, util/compile_cache.py) comes with "
                "ROADMAP Queue 1 item 12")
        if self.device is None:
            raise ValueError("init() the network before warmup()")
        if shapes is None:
            if self.conf.input_shape is None:
                raise ValueError("warmup() needs shapes= or conf.input_shape")
            if (self._bucketing is None
                    or not isinstance(self._bucketing.batch_buckets, tuple)):
                raise ValueError(
                    "warmup() without shapes= needs explicit batch_buckets "
                    "on the conf (pow2 has no finite bucket list)")
            shapes = [(b,) + tuple(self.conf.input_shape)
                      for b in self._bucketing.batch_buckets]
        if not capture.enabled():
            return 0  # capture.disabled(): no program is built
        built = 0
        for shape in shapes:
            shape = tuple(int(d) for d in shape)
            b = shape[0]
            x = torch.zeros(shape, dtype=dtype, device=self.device)
            if train:
                y = torch.zeros((b,) + self._output_shape,
                                dtype=torch.float32, device=self.device)
                w = dev_weights(self._w_cache, b, b, self.device)
                args = (x, y, w, None, None)
                if _dispatch_sig(*args) not in self._aot_steps:
                    self._step_sizes()
                    self._program(self._aot_steps, _dispatch_sig(*args),
                                  "MultiLayerNetwork.train_step",
                                  self._train_body, args)
                    built += 1
            if inference:
                key = (False, _dispatch_sig(x, None))
                if key not in self._aot_forward:
                    self._program(self._aot_forward, key,
                                  "MultiLayerNetwork.forward",
                                  self._forward_program_body(False),
                                  (x, None), train=False)
                    built += 1
        return built

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
