"""ComputationGraph — DAG network (counterpart of
deeplearning4j_tpu/nn/computation_graph.py): inference and training.

The configuration, its JSON and the GraphBuilder DSL mirror the reference
(``ComputationGraphConfiguration`` :59, ``GraphBuilder`` :221). The runtime
walks the topological order eagerly in PyTorch: each layer's ``apply`` on
the node's gathered input, each vertex's ``apply`` on its inputs. A layer
node with several inputs gets the implicit feature-axis merge, as in the
reference.

``compute_dtype="bfloat16"`` casts the inputs and the params (not the
batchnorm running statistics) to bf16 for the forward, as the reference's
``_cast``/``_cast_params`` do (:553-568); the inference forward caches the
casts per param version, the training forward casts inside autograd so the
gradients reach the fp32 params.

Training (``fit`` :1200, ``_fit_batch`` :1236, ``make_step_fn`` :1145, the
non-fused per-node updater path): one eager step is the training forward
(batch-statistics batchnorm), the loss of every output's ``compute_loss``
(0/1 row weights always passed, so a bucket-padded batch takes the
unpadded mean) plus the layers' l1/l2 penalty, ``torch.autograd.grad`` of
it with respect to the params (the conv backward on the dgrad and wgrad
kernels), and each node's updater (its own, else the conf's, else
Sgd(0.1)), applied in place. ``iteration``, ``epoch`` and ``score_value``
follow the reference; ``score`` is the inference-mode loss (without the
penalty, as the reference's ``_loss_eval`` ``:1572-1612``), ``evaluate``
(``:1615``) runs ``output`` over an iterator into an ``Evaluation`` of
the first output. Listeners (``set_listeners``, ``nn/listeners.py``) are
called after every update through the coalescing dispatcher, whose window
is the conf's ``sync_every``; the end of an epoch flushes it and calls
``on_epoch_end``.

Dropout applies in training, drawn from the graph's ``torch.Generator``
(seeded from ``conf.seed`` on its device at ``init``), as the layers'
``dropout`` says (``nn/layers.py``).

Not ported, each with its slice (ROADMAP Queue 1): the fused optimizer and
loss scaling (``fused_update``/``loss_scale`` raise in ``fit``), masks,
TBPTT and ``rnn_time_step`` in the graph (item 14; the MultiLayerNetwork
has them), SharedLayer (item 4), telemetry and AOT warmup (item 12), remat
segments (item 12: ``remat_policy`` and ``stage_barriers`` are kept as
config and leave the step's arithmetic as it is, as they do in the
reference), pipelining (item 10).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.data.bucketing import (BucketingPolicy,
                                                     dev_weights)
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.device import as_tensor, resolve_device
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn import vertices as V
from deeplearning4j_tpu_torch.nn.conf import (DEFAULT_UPDATER, INERT_KNOBS,
                                              Builder,
                                              _buckets_from_json,
                                              _buckets_to_json, _detuple,
                                              kernel_impl_from_json,
                                              kernel_impl_to_json)
from deeplearning4j_tpu_torch.nn.listeners import CoalescingListenerDispatcher
from deeplearning4j_tpu_torch.ops import kernels as _kern


@dataclasses.dataclass
class GraphNode:
    name: str
    node: Any  # Layer | GraphVertex
    inputs: List[str]

    @property
    def is_layer(self) -> bool:
        return isinstance(self.node, L.Layer)


@dataclasses.dataclass
class ComputationGraphConfiguration:
    """DAG description (ComputationGraphConfiguration.java parity).
    ``knobs`` holds the :data:`~deeplearning4j_tpu_torch.nn.conf.INERT_KNOBS`
    the port keeps for later slices; ``remat_stages`` are the node names
    that end a stage (``stage_boundary``)."""

    inputs: List[str]
    nodes: List[GraphNode]
    outputs: List[str]
    seed: int = 12345
    updater: Optional[dict] = None
    input_shapes: Optional[List[Tuple[int, ...]]] = None  # excl. batch
    compute_dtype: str = "float32"
    kernel_impl: Optional[str] = None  # auto | exact | cuda | None (ambient)
    batch_buckets: Any = None
    seq_buckets: Any = None
    remat_stages: Optional[Tuple[str, ...]] = None
    knobs: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(INERT_KNOBS))

    @property
    def input_shape(self) -> Optional[Tuple[int, ...]]:
        """The single input's shape (excl. batch), for serving warmup."""
        return tuple(self.input_shapes[0]) if self.input_shapes else None

    # -- serialization: the reference's JSON, key for key ------------------
    def to_dict(self) -> dict:
        k = {**INERT_KNOBS, **self.knobs}
        return {
            "inputs": list(self.inputs),
            "outputs": list(self.outputs),
            "seed": self.seed,
            "updater": self.updater,
            "input_shapes": [list(s) for s in self.input_shapes]
            if self.input_shapes else None,
            "compute_dtype": self.compute_dtype,
            "tbptt_length": k["tbptt_length"],
            "remat_policy": k["remat_policy"],
            "remat_stages": list(self.remat_stages)
            if self.remat_stages else None,
            "stage_barriers": k["stage_barriers"],
            "sync_every": k["sync_every"],
            "batch_buckets": _buckets_to_json(self.batch_buckets),
            "seq_buckets": _buckets_to_json(self.seq_buckets),
            "kernel_impl": kernel_impl_to_json(self.kernel_impl),
            **{name: k[name] for name in list(INERT_KNOBS)[4:]},
            "nodes": [{"name": n.name, "inputs": list(n.inputs),
                       "node": n.node.to_dict()} for n in self.nodes],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)

        def denode(nd):
            if "@layer" in nd:
                nd = {k: _detuple(v) if isinstance(v, list) else v
                      for k, v in nd.items()}
                return L.layer_from_dict(nd)
            return V.vertex_from_dict(nd)

        return ComputationGraphConfiguration(
            inputs=list(d["inputs"]),
            outputs=list(d["outputs"]),
            seed=d["seed"],
            updater=d.get("updater"),
            input_shapes=[tuple(s) for s in d["input_shapes"]]
            if d.get("input_shapes") else None,
            compute_dtype=d.get("compute_dtype", "float32"),
            kernel_impl=kernel_impl_from_json(d.get("kernel_impl")),
            batch_buckets=_buckets_from_json(d.get("batch_buckets")),
            seq_buckets=_buckets_from_json(d.get("seq_buckets")),
            remat_stages=tuple(d["remat_stages"])
            if d.get("remat_stages") else None,
            knobs={k: d.get(k, v) for k, v in INERT_KNOBS.items()},
            nodes=[GraphNode(n["name"], denode(n["node"]), list(n["inputs"]))
                   for n in d["nodes"]],
        )

    def topological_order(self) -> List[GraphNode]:
        """Kahn's algorithm over the node list (GraphIndices parity)."""
        by_name = {n.name: n for n in self.nodes}
        indeg = {n.name: sum(1 for i in n.inputs if i in by_name)
                 for n in self.nodes}
        consumers: Dict[str, List[str]] = {}
        for n in self.nodes:
            for i in n.inputs:
                if i not in by_name and i not in self.inputs:
                    raise ValueError(
                        f"node {n.name!r} consumes unknown input {i!r}")
                consumers.setdefault(i, []).append(n.name)
        ready = [n for n in self.nodes if indeg[n.name] == 0]
        order: List[GraphNode] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for cname in consumers.get(n.name, ()):
                indeg[cname] -= 1
                if indeg[cname] == 0:
                    ready.append(by_name[cname])
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order


class GraphBuilder:
    """Fluent DSL (ComputationGraphConfiguration.GraphBuilder parity)."""

    def __init__(self, parent=None):
        self._p = parent  # nn.conf.Builder carrying global settings
        self._inputs: List[str] = []
        self._nodes: List[GraphNode] = []
        self._outputs: List[str] = []
        self._input_shapes: Optional[List[tuple]] = None
        self._stage_ends: List[str] = []

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: L.Layer,
                  *inputs: str) -> "GraphBuilder":
        self._nodes.append(GraphNode(name, layer, list(inputs)))
        return self

    def add_vertex(self, name: str, vertex: V.GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._nodes.append(GraphNode(name, vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *shapes) -> "GraphBuilder":
        self._input_shapes = [tuple(s) for s in shapes]
        return self

    def stage_boundary(self, *node_names: str) -> "GraphBuilder":
        """Record remat/fusion stage boundaries: each named node ENDS a
        stage (the last added node when none is named). Kept as config."""
        if not node_names:
            if not self._nodes:
                raise ValueError("stage_boundary() before any node")
            node_names = (self._nodes[-1].name,)
        for n in node_names:
            if n not in self._stage_ends:
                self._stage_ends.append(n)
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("add_inputs required")
        if not self._outputs:
            raise ValueError("set_outputs required")
        p = self._p or Builder()
        return ComputationGraphConfiguration(
            inputs=list(self._inputs),
            nodes=list(self._nodes),
            outputs=list(self._outputs),
            seed=p._seed,
            updater=p._updater if self._p is not None else None,
            input_shapes=self._input_shapes,
            compute_dtype=p._compute_dtype,
            kernel_impl=p._kernel_impl,
            remat_stages=tuple(self._stage_ends) or None,
            knobs=dict(p._knobs),
        )


class ComputationGraph:
    """DAG network runtime (ComputationGraph.java parity).
    ``params``/``states``/``opt_states`` are dicts node-name -> the node's
    tree, keyed as the reference keys them; params are plain tensors,
    marked as needing a gradient only inside a training step."""

    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.topo = conf.topological_order()
        self.params: Dict[str, dict] = {}
        self.states: Dict[str, dict] = {}
        self.opt_states: Dict[str, Any] = {}
        self.iteration = 0
        self.epoch = 0
        self.listeners: list = []
        self.score_value: Any = float("nan")
        self.last_iteration_wall_ns = None  # set during coalesced dispatch
        self._dispatcher = CoalescingListenerDispatcher(
            self, {**INERT_KNOBS, **conf.knobs}["sync_every"])
        self.device: Optional[torch.device] = None
        self._gen: Optional[torch.Generator] = None  # dropout, set by init
        self._cast_cache: Dict[Tuple[str, str], tuple] = {}
        self._w_cache: dict = {}
        # per-node updater (:373-378): the node's own, else the conf's,
        # else Sgd(0.1); nodes with equal updaters step together
        self._updaters: Dict[str, upd.Updater] = {
            n.name: upd.updater_from_dict(
                n.node.updater or conf.updater or DEFAULT_UPDATER)
            for n in self.topo if n.is_layer}
        self._update_groups = upd.group_by_rule(self._updaters)
        names = {n.name for n in self.topo}
        consumed = {i for n in self.topo for i in n.inputs}
        for name in conf.outputs:
            if name not in names:
                raise ValueError(f"unknown output {name!r}")
            if name in consumed:
                raise ValueError(
                    f"output {name!r} is consumed by another node — outputs "
                    "must be terminal (IOutputLayer semantics)")
        self._bucketing = BucketingPolicy.from_conf(conf)

    # ------------------------------------------------------------------ init
    def init(self, input_shapes=None, device=None) -> "ComputationGraph":
        """Initialize params/states from a ``torch.Generator`` seeded with
        ``conf.seed`` (one draw per layer, in topological order) and place
        them on ``device``: CUDA unless the caller names another."""
        shapes = input_shapes or self.conf.input_shapes
        if shapes is None:
            raise ValueError(
                "input_shapes required (set_input_types on the builder)")
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        shape_of = {name: tuple(s) for name, s in zip(self.conf.inputs,
                                                      shapes)}
        self.params, self.states = {}, {}
        for n in self.topo:
            in_shapes = [shape_of[i] for i in n.inputs]
            if n.is_layer:
                ishape = self._merged_shape(in_shapes)
                p, s = n.node.initialize(gen, ishape)
                self.params[n.name] = self._place(p)
                self.states[n.name] = self._place(s)
                shape_of[n.name] = tuple(n.node.output_shape(ishape))
            else:
                self.params[n.name] = {}
                self.states[n.name] = {}
                shape_of[n.name] = tuple(n.node.output_shape(*in_shapes))
        self.opt_states = {name: u.init_state(self.params[name])
                           for name, u in self._updaters.items()}
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(self.conf.seed))
        return self

    def _place(self, tree: dict) -> dict:
        return {k: v.to(self.device) for k, v in tree.items()}

    @staticmethod
    def _merged_shape(in_shapes):
        if len(in_shapes) == 1:
            return in_shapes[0]
        base = list(in_shapes[0])
        base[-1] = sum(s[-1] for s in in_shapes)
        return tuple(base)

    def num_params(self) -> int:
        return sum(int(t.numel()) for p in self.params.values()
                   for t in p.values())

    # --------------------------------------------------------------- forward
    def _cast(self, x):
        if self.conf.compute_dtype == "bfloat16" and x.is_floating_point():
            return x.to(torch.bfloat16)
        return x

    def _cast_params(self, params):
        """bf16 copies of the params, made once per param tensor: a copy is
        reused while its source is the same tensor at the same version
        (an in-place update bumps ``_version`` and triggers a fresh cast)."""
        if self.conf.compute_dtype != "bfloat16":
            return params
        out = {}
        for name, p in params.items():
            out[name] = {}
            for k, v in p.items():
                hit = self._cast_cache.get((name, k))
                if hit is None or hit[0] is not v or hit[1] != v._version:
                    hit = (v, v._version, self._cast(v))
                    self._cast_cache[(name, k)] = hit
                out[name][k] = hit[2]
        return out

    def _kscope(self):
        """Kernel-dispatch scope for this graph's layers (ops/kernels)."""
        return _kern.impl_scope(self.conf.kernel_impl)

    def _gather_input(self, acts, node):
        xs = [acts[i] for i in node.inputs]
        if node.is_layer:
            return xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        return xs

    def _forward(self, params, states, inputs, *, training=False):
        """inputs: dict name->tensor. Returns dict name->activation (the
        inference forward leaves ``states`` as they are)."""
        with self._kscope(), torch.inference_mode():
            acts = {k: self._cast(v) for k, v in inputs.items()}
            cparams = self._cast_params(params)
            for n in self.topo:
                if n.is_layer:
                    acts[n.name], _ = n.node.apply(
                        cparams[n.name], states[n.name],
                        self._gather_input(acts, n), training=training)
                else:
                    acts[n.name] = n.node.apply(*self._gather_input(acts, n))
            return acts

    def _require_init(self):
        if self.device is None:
            raise ValueError("init() the graph first")

    # ---------------------------------------------------------------- output
    def make_forward_fn(self):
        """fn(params, states, x) -> first-output activations (single-input
        graphs), for serving wrappers."""
        in_name, out_name = self.conf.inputs[0], self.conf.outputs[0]

        def fwd(params, states, x):
            return self._forward(params, states, {in_name: x})[out_name]

        return fwd

    def output(self, *inputs, train: bool = False):
        """Forward pass; a list of output activations, or one tensor when
        the graph has one output. With ``batch_buckets`` on the conf the
        batch pads up to its bucket and the padding rows are sliced off.
        ``train=True`` uses training-mode (batch) statistics and no
        dropout, and leaves the running statistics as they are, as the
        reference's ``output(train=True)``."""
        self._require_init()
        ins = [as_tensor(x, self.device) for x in inputs]
        real_n = None
        if self._bucketing is not None:
            n = ins[0].shape[0]
            size = self._bucketing.bucket_batch(n)
            if size != n:
                real_n = n
                ins = [torch.cat([t, t.new_zeros((size - n,) + t.shape[1:])])
                       for t in ins]
        acts = self._forward(self.params, self.states,
                             dict(zip(self.conf.inputs, ins)), training=train)
        outs = [acts[name] for name in self.conf.outputs]
        if real_n is not None:
            outs = [o[:real_n] for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, *inputs) -> Dict[str, torch.Tensor]:
        """All vertex activations by name (ComputationGraph.feedForward)."""
        self._require_init()
        ins = dict(zip(self.conf.inputs,
                       [as_tensor(x, self.device) for x in inputs]))
        return self._forward(self.params, self.states, ins)

    # ---------------------------------------------------------------- train
    def _check_trainable(self):
        self._require_init()
        k = {**INERT_KNOBS, **self.conf.knobs}
        if k["fused_update"] or k["loss_scale"] != "none":
            raise NotImplementedError(
                "fused_update / loss_scale are not ported yet: the fused "
                "optimizer (FusedUpdateEngine) and loss scaling come with the "
                "parallel-training slice (ROADMAP Queue 1 item 10)")

    def _loss(self, inputs, labels, weights, *, training=True):
        """Sum of the output layers' losses (+ the l1/l2 penalty in
        training) and the new states (:667-723). The training forward
        casts the fp32 params inside autograd (bf16 compute), the
        inference loss takes them through the cast cache."""
        params, states = self.params, self.states
        acts = {k: self._cast(v) for k, v in inputs.items()}
        if training:
            cparams = {name: {k: self._cast(v) for k, v in p.items()}
                       for name, p in params.items()}
        else:
            cparams = self._cast_params(params)
        new_states = dict(states)
        out_names = set(self.conf.outputs)
        gen = self._gen if training else None
        loss = 0.0
        for n in self.topo:
            if not n.is_layer:
                acts[n.name] = n.node.apply(*self._gather_input(acts, n))
                continue
            x = self._gather_input(acts, n)
            if n.name in out_names:
                if not hasattr(n.node, "compute_loss"):
                    raise ValueError(
                        f"output {n.name!r} must be an OutputLayer/LossLayer")
                out_loss = n.node.compute_loss(
                    cparams[n.name], states[n.name], x, labels[n.name],
                    training=training, gen=gen, weights=weights)
                loss = loss + out_loss.to(
                    torch.promote_types(out_loss.dtype, torch.float32))
                acts[n.name] = x  # terminal; activation unused downstream
            else:
                acts[n.name], new_states[n.name] = n.node.apply(
                    cparams[n.name], states[n.name], x, training=training,
                    gen=gen)
        if training:
            for n in self.topo:
                if n.is_layer:
                    loss = loss + n.node.regularization(params[n.name])
        return loss, new_states

    def _batch(self, features, labels):
        """Inputs/labels as tensors on this graph's device, padded to the
        batch bucket, and the 0/1 row weights."""
        if not isinstance(features, (list, tuple)):
            features = [features]
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        feats = [as_tensor(f, self.device) for f in features]
        labs = [as_tensor(y, self.device) for y in labels]
        real_n = feats[0].shape[0]
        if self._bucketing is not None:
            feats, labs = self._bucketing.pad_graph_batch(feats, labs)
        weights = dev_weights(self._w_cache, feats[0].shape[0], real_n,
                              self.device)
        return (dict(zip(self.conf.inputs, feats)),
                dict(zip(self.conf.outputs, labs)), weights)

    def _gradients(self, inputs, labels, weights):
        """(loss, grads, new_states) of one training forward + backward,
        leaving params, states and optimizer states as they are. Nodes
        whose updater is NoOp are frozen: their params get no gradient."""
        leaves = [(name, k, t) for name, u in self._updaters.items()
                  if not isinstance(u, upd.NoOp)
                  for k, t in self.params[name].items()
                  if t.is_floating_point()]
        for _, _, t in leaves:
            t.requires_grad_(True)
        try:
            with self._kscope():
                loss, new_states = self._loss(inputs, labels, weights)
                gs = torch.autograd.grad(loss, [t for _, _, t in leaves],
                                         allow_unused=True)
        finally:
            for _, _, t in leaves:
                t.requires_grad_(False)
        grads: Dict[str, dict] = {}
        for (name, k, t), g in zip(leaves, gs):
            grads.setdefault(name, {})[k] = (torch.zeros_like(t) if g is None
                                             else g)
        new_states = {name: {k: v.detach() for k, v in s.items()}
                      for name, s in new_states.items()}
        return loss.detach(), grads, new_states

    def compute_gradient_and_score(self, features, labels):
        """(grads, score) of one training step on this batch without
        applying it (ComputationGraph.computeGradientAndScore): grads is
        node-name -> {key: tensor}, score the loss as a 0-d tensor. Params,
        states and optimizer states are left as they are."""
        self._check_trainable()
        loss, grads, _ = self._gradients(*self._batch(features, labels))
        return grads, loss

    def fit(self, data, labels=None, epochs: int = 1):
        """fit(x, y) | fit([x1, x2], [y1, ...]) | fit(DataSet) |
        fit(iterable of DataSet/MultiDataSet) — :1200 parity."""
        if labels is not None:
            for _ in range(epochs):
                self._fit_batch(data, labels)
                self._end_epoch()
            return self
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            for ds in data:
                _refuse_masks(ds)
                self._fit_batch(ds.features, ds.labels)
            self._end_epoch()
        return self

    def _end_epoch(self):
        """``:1229-1234``: the listeners see the whole epoch before its
        end."""
        self._dispatcher.flush()
        self.epoch += 1
        for lst in self.listeners:
            if hasattr(lst, "on_epoch_end"):
                lst.on_epoch_end(self)

    def _fit_batch(self, features, labels):
        """One step (:1236): forward, loss, backward, updaters in place.
        ``score_value`` keeps the loss as a device tensor (no host sync per
        step); ``get_score()`` reads it. The listeners get the iteration
        through the dispatcher (``:1301-1308``)."""
        self._check_trainable()
        loss, grads, new_states = self._gradients(
            *self._batch(features, labels))
        upd.step_groups(self._update_groups, self.params, grads,
                        self.opt_states, self.iteration)
        self.states = new_states
        self.score_value = loss
        self.iteration += 1
        self._dispatcher.iteration_done(loss, self.iteration, self.epoch)

    def score(self, dataset=None, x=None, y=None) -> float:
        """Inference-mode loss (running batchnorm statistics, no penalty)
        of a batch, as a float (:1546-1612)."""
        self._require_init()
        if dataset is not None:
            x, y = dataset.features, dataset.labels
        inputs, labels, weights = self._batch(x, y)
        with self._kscope(), torch.inference_mode():
            loss, _ = self._loss(inputs, labels, weights, training=False)
        return float(loss)

    def evaluate(self, iterator) -> Evaluation:
        """Classification metrics of the first output over an iterator of
        DataSets or MultiDataSets (``:1615``); masked data is refused, as
        in ``fit``."""
        ev = Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            _refuse_masks(ds)
            feats = (ds.features if isinstance(ds.features, (list, tuple))
                     else [ds.features])
            preds = self.output(*feats)
            p0 = preds[0] if isinstance(preds, list) else preds
            l0 = (ds.labels[0] if isinstance(ds.labels, (list, tuple))
                  else ds.labels)
            ev.eval(l0, p0)
        return ev

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def get_score(self) -> float:
        return float(self.score_value)


def _refuse_masks(ds):
    masks = (getattr(ds, "features_mask", None),
             getattr(ds, "labels_mask", None),
             getattr(ds, "features_masks", None),
             getattr(ds, "labels_masks", None))
    if any(m is not None for m in masks):
        raise NotImplementedError(
            "masked training and TBPTT in ComputationGraph are not ported "
            "yet (ROADMAP.md Queue 1 item 14); MultiLayerNetwork.fit takes "
            "masks")
