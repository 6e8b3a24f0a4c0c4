"""MultiLayerNetwork — the linear layer stack (counterpart of
deeplearning4j_tpu/nn/multilayer.py), inference.

The configuration is ``nn/conf.py``'s :class:`MultiLayerConfiguration`
(built by ``NeuralNetConfiguration.builder().list()``, JSON shared with the
reference). The runtime runs the layers in order eagerly, each layer's
``apply`` on the previous output, inside the conf's kernel-dispatch scope.

- ``init(device=)`` (reference ``:151``) draws every layer's params from
  one ``torch.Generator`` seeded with ``conf.seed``, in layer order, and
  places them on ``device``: CUDA unless the caller names another.
- ``compute_dtype="bfloat16"`` casts a floating input and the params to
  bf16 for the forward (``_cast``/``_cast_params``, ``:195-206``); integer
  inputs (token ids) stay as they are. The bf16 copies of the params are
  cached per param version, as in ``ComputationGraph``.
- Masks (``:214-235``): ``output(x, mask=m)`` hands the (B, T) mask to
  every layer whose ``apply`` takes one while the activations are (B, T,
  ...), and drops it once a layer has consumed the time axis.
- Batch bucketing (``batch_buckets``) pads an unmasked batch up to its
  bucket and slices the padding rows off the result.

Not ported yet: ``fit`` (with TBPTT), ``rnn_time_step`` and ``score``
raise ``NotImplementedError`` (ROADMAP.md Queue 1: the recurrent slice
brings ``fit``, TBPTT and ``rnn_time_step`` with the LSTM kernel, the
LeNet milestone ``score`` and ``evaluate``). Remat stages are kept as
config.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
from deeplearning4j_tpu_torch.device import as_tensor, resolve_device
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.ops import kernels as _kern

_NOT_PORTED = ("MultiLayerNetwork.{} is not ported yet: see ROADMAP.md "
               "Queue 1 (MLN fit, TBPTT and rnn_time_step come with the "
               "recurrent slice, score with the LeNet milestone)")


class MultiLayerNetwork:
    """Layer-stack runtime (MultiLayerNetwork.java parity). ``params`` and
    ``states`` are lists of per-layer dicts keyed as the reference keys
    them."""

    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers = conf.layers
        self.params: List[dict] = []
        self.states: List[dict] = []
        self.device: Optional[torch.device] = None
        self._cast_cache: Dict[Tuple[int, str], tuple] = {}
        # which layers' apply() takes a mask (setLayerMaskArrays parity)
        self._mask_aware = [
            "mask" in inspect.signature(lyr.apply).parameters
            for lyr in self.layers]
        self._bucketing = BucketingPolicy.from_conf(conf)

    # ------------------------------------------------------------------ init
    def init(self, input_shape=None, device=None) -> "MultiLayerNetwork":
        """Initialize params/states from a ``torch.Generator`` seeded with
        ``conf.seed`` on ``device`` (CUDA unless named otherwise)."""
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
            self.params.append({k: v.to(self.device) for k, v in p.items()})
            self.states.append({k: v.to(self.device) for k, v in s.items()})
            cur = lyr.output_shape(cur)
        self._cast_cache = {}
        return self

    def num_params(self) -> int:
        return sum(int(t.numel()) for p in self.params for t in p.values())

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
            for k, v in p.items():
                hit = self._cast_cache.get((i, k))
                if hit is None or hit[0] is not v or hit[1] != v._version:
                    hit = (v, v._version, self._cast(v))
                    self._cast_cache[(i, k)] = hit
                layer[k] = hit[2]
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

    # ------------------------------------------------------------ not ported
    def fit(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(_NOT_PORTED.format("fit"))

    def rnn_time_step(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(_NOT_PORTED.format("rnn_time_step"))

    def score(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(_NOT_PORTED.format("score"))
