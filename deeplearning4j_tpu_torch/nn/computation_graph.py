"""ComputationGraph — DAG network (counterpart of
deeplearning4j_tpu/nn/computation_graph.py): inference and training.

The configuration, its JSON and the GraphBuilder DSL mirror the reference
(``ComputationGraphConfiguration`` :59, ``GraphBuilder`` :221). The runtime
walks the topological order in PyTorch: each layer's ``apply`` on the
node's gathered input, each vertex's ``apply`` on its inputs. A layer node
with several inputs gets the implicit feature-axis merge, as in the
reference.

Compiled programs (``nn/capture.py``; the reference's jitted, donated
``_train_step`` ``:1135-1143``, ``_tbptt_step`` ``:906-935`` and
``_forward_jit`` ``:533-534``): ``fit``, the TBPTT loop and ``output``
dispatch on the batch's shape signature (``_dispatch_sig`` of the input
and label dicts, the row weights and the masks, one array or a dict by
name; ``:1271``, ``:1533-1534``) to a program per signature, held in
``_aot_steps``, ``_tbptt_steps`` and ``_aot_forward``: on a CUDA device
a CUDA graph, captured the first time its signature comes and then
replayed; on the CPU the same body on the same static buffers, eagerly.
``warmup`` (``:1311-1386``) builds them per bucket before traffic;
``capture.disabled()`` runs every step eagerly. Rebinding the params,
states or optimizer states (``init``, ``interop.load_reference``) drops
the programs.

``compute_dtype="bfloat16"`` casts the inputs and the params (not the
batchnorm running statistics) to bf16 for the forward, as the reference's
``_cast``/``_cast_params`` do (:553-568); the eager inference forward
caches the casts per param version, a forward program casts inside its
graph (so a replay after ``fit`` sees the new params), and the training
forward casts inside autograd so the gradients reach the fp32 params.

Training (``fit`` :1200, ``_fit_batch`` :1236, ``make_step_fn`` :1145, the
non-fused per-node updater path): one step is the training forward
(batch-statistics batchnorm), the loss of every output's ``compute_loss``
(0/1 row weights always passed, so a bucket-padded batch takes the
unpadded mean) plus the layers' l1/l2 penalty, ``torch.autograd.grad`` of
it with respect to the params (the conv backward on the dgrad and wgrad
kernels), and each node's updater (its own, else the conf's, else
Sgd(0.1)), applied in place at this iteration's step sizes
(``nn/updaters.py::StepSizes``), with the new layer states copied into the
graph's own tensors. ``iteration``, ``epoch`` and ``score_value``
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

Masks (``:318-349``, ``:577-612``): a (B, T) feature mask is one array
shared by every node, or a dict by input name (a MultiDataSet's mask list,
``_mask_dict``), where each node inherits the first mask among its inputs
(``_arriving_mask``). A node gets the mask while its input is (B, T, F)
and its ``apply`` takes one; an output's loss gets its label mask (a dict
by output name, or one array), else the arriving feature mask. ``output``
and ``evaluate`` take the shared feature mask, as in the reference.

Truncated BPTT (``tbptt_length`` k, ``:822-1010``): a batch whose first
sequence input is longer than k, with per-step labels, trains as k-step
segments, one update each; the recurrent nodes' carries flow forward
detached, per-input masks are sliced independently, and under bucketing
the ragged tail pads to k. ``rnn_time_step`` (``:1078``) keeps the
recurrent nodes' carries between calls until ``rnn_clear_previous_state``;
a Bidirectional node raises there.

Not ported, each with its slice (ROADMAP Queue 1): the fused optimizer and
loss scaling (``fused_update``/``loss_scale`` raise in ``fit``),
SharedLayer (item 4), telemetry and the AOT store behind ``warmup``'s
``export_dir`` (item 12; ``score``, ``feed_forward`` and
``rnn_time_step`` run eagerly), remat segments
(item 12: ``remat_policy`` and ``stage_barriers`` are kept as config and
leave the step's arithmetic as it is, as they do in the reference; the
reference's masked graphs take its plain path), pipelining (item 10).
"""

from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.data.bucketing import (BucketingPolicy,
                                                     dev_weights, map_mask)
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.device import as_tensor, resolve_device
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn import capture
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
from deeplearning4j_tpu_torch.nn.recurrent import Bidirectional, is_recurrent
from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.tree import (tree_copy_, tree_items,
                                           tree_leaves, tree_map, tree_set)

_dispatch_sig = capture.dispatch_sig


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

    @property
    def tbptt_length(self) -> int:
        """The truncated-BPTT segment length (0: whole-sequence BPTT)."""
        return int(self.knobs.get("tbptt_length") or 0)

    @tbptt_length.setter
    def tbptt_length(self, k: int) -> None:
        self.knobs["tbptt_length"] = int(k)

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

        def fix(nd):
            # a wrapper (Bidirectional) holds its inner layer's dict
            return {k: fix(v) if isinstance(v, dict) and "@layer" in v
                    else _detuple(v) if isinstance(v, list) else v
                    for k, v in nd.items()}

        def denode(nd):
            if "@layer" in nd:
                return L.layer_from_dict(fix(nd))
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
        self._tbptt: Optional[int] = None
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

    def tbptt_length(self, k: int) -> "GraphBuilder":
        """Truncated-BPTT segment length (``:263``; over the parent
        builder's)."""
        self._tbptt = int(k)
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
        knobs = dict(p._knobs)
        if self._tbptt is not None:
            knobs["tbptt_length"] = self._tbptt
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
            knobs=knobs,
        )


class ComputationGraph(capture.CompiledSteps):
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
        # which nodes' apply()/compute_loss() take a mask
        # (feedForwardMaskArrays parity)
        self._takes_mask = {
            n.name: "mask" in inspect.signature(n.node.apply).parameters
            for n in self.topo if n.is_layer}
        self._loss_takes_mask = {
            n.name: "mask" in inspect.signature(
                n.node.compute_loss).parameters
            for n in self.topo if hasattr(n.node, "compute_loss")}
        self._rnn_carries: Optional[dict] = None
        self._shape_of: Dict[str, tuple] = {}
        self._drop_programs()

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
        self._rnn_carries = None
        self._shape_of = shape_of
        self._drop_programs()
        return self

    def _place(self, tree: dict) -> dict:
        return tree_map(lambda v: v.to(self.device), tree)

    @staticmethod
    def _merged_shape(in_shapes):
        if len(in_shapes) == 1:
            return in_shapes[0]
        base = list(in_shapes[0])
        base[-1] = sum(s[-1] for s in in_shapes)
        return tuple(base)

    def num_params(self) -> int:
        return sum(int(t.numel()) for t in tree_leaves(self.params))

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
            for path, v in tree_items(p):
                hit = self._cast_cache.get((name, path))
                if hit is None or hit[0] is not v or hit[1] != v._version:
                    hit = (v, v._version, self._cast(v))
                    self._cast_cache[(name, path)] = hit
                tree_set(out[name], path, hit[2])
        return out

    def _kscope(self):
        """Kernel-dispatch scope for this graph's layers (ops/kernels)."""
        return _kern.impl_scope(self.conf.kernel_impl)

    def _gather_input(self, acts, node):
        xs = [acts[i] for i in node.inputs]
        if node.is_layer:
            return xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        return xs

    def _mask_kw(self, node, mask, x):
        """The mask threading rule (``:596``): a (B, T) mask reaches a node
        that takes one while its input keeps the (B, T, ...) shape."""
        if (mask is not None and x.dim() == 3
                and tuple(mask.shape[:2]) == tuple(x.shape[:2])
                and self._takes_mask[node.name]):
            return {"mask": mask}
        return {}

    def _loss_mask_kw(self, node, mask, label_mask, x):
        """An output's loss mask (``:585``): its label mask, else the
        arriving feature mask, by the same shape rule."""
        lm = label_mask if label_mask is not None else mask
        if (lm is not None and x.dim() == 3
                and tuple(lm.shape[:2]) == tuple(x.shape[:2])
                and self._loss_takes_mask[node.name]):
            return {"mask": lm}
        return {}

    def _forward(self, params, states, inputs, *, training=False, mask=None,
                 cached_cast=True):
        """inputs: dict name->tensor, ``mask`` one (B, T) feature mask for
        every node. Returns dict name->activation (the inference forward
        leaves ``states`` as they are). ``cached_cast=False`` casts the
        params afresh (a forward program's, inside its graph)."""
        with self._kscope(), torch.inference_mode():
            acts = {k: self._cast(v) for k, v in inputs.items()}
            cparams = (self._cast_params(params) if cached_cast else
                       {name: tree_map(self._cast, p)
                        for name, p in params.items()})
            for n in self.topo:
                x = self._gather_input(acts, n)
                if n.is_layer:
                    acts[n.name], _ = n.node.apply(
                        cparams[n.name], states[n.name], x,
                        training=training, **self._mask_kw(n, mask, x))
                else:
                    acts[n.name] = n.node.apply(*x)
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

    def output(self, *inputs, train: bool = False, mask=None):
        """Forward pass; a list of output activations, or one tensor when
        the graph has one output. ``mask``: the (B, T) feature mask of a
        sequence graph. With ``batch_buckets`` on the conf an unmasked
        batch pads up to its bucket and the padding rows are sliced off.
        ``train=True`` uses training-mode (batch) statistics and no
        dropout, and leaves the running statistics as they are, as the
        reference's ``output(train=True)``."""
        self._require_init()
        ins = [as_tensor(x, self.device) for x in inputs]
        real_n = None
        if self._bucketing is not None and mask is None:
            n = ins[0].shape[0]
            size = self._bucketing.bucket_batch(n)
            if size != n:
                real_n = n
                ins = [torch.cat([t, t.new_zeros((size - n,) + t.shape[1:])])
                       for t in ins]
        ins = dict(zip(self.conf.inputs, ins))
        mk = _as_mask(mask, self.device)
        if capture.enabled():
            key = (bool(train), _dispatch_sig(ins, mk))
            outs = [o.clone() for o in self._program(
                self._aot_forward, key, "ComputationGraph.forward",
                self._forward_program_body(bool(train)), (ins, mk),
                train=False)(ins, mk)]
        else:
            acts = self._forward(self.params, self.states, ins,
                                 training=train, mask=mk)
            outs = [acts[name] for name in self.conf.outputs]
        if real_n is not None:
            outs = [o[:real_n] for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def _forward_program_body(self, training):
        """The forward a program captures: the outputs' activations, the
        params cast inside the graph."""
        def body(inputs, mask):
            acts = self._forward(self.params, self.states, inputs,
                                 training=training, mask=mask,
                                 cached_cast=False)
            return tuple(acts[name] for name in self.conf.outputs)
        return body

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

    def _loss(self, inputs, labels, weights, mask=None, label_mask=None,
              carries=None, *, training=True):
        """Sum of the output layers' losses (+ the l1/l2 penalty in
        training), the new states and the new carries (``_loss_body``
        ``:667-723``, ``_loss_tbptt_body`` ``:850-905``, ``_loss_eval``
        ``:1572-1612``). ``mask``/``label_mask``: one (B, T) array or a
        dict by input/output name. ``carries``: None for the whole-sequence
        step, else the recurrent nodes' carries by name, each node running
        ``apply_seq`` on its own after its input dropout. The training
        forward casts the fp32 params inside autograd (bf16 compute), the
        inference loss takes them through the cast cache."""
        params, states = self.params, self.states
        acts = {k: self._cast(v) for k, v in inputs.items()}
        if training:
            cparams = {name: tree_map(self._cast, p)
                       for name, p in params.items()}
        else:
            cparams = self._cast_params(params)
        new_states = dict(states)
        new_carries = None if carries is None else dict(carries)
        out_names = set(self.conf.outputs)
        produced = dict(mask) if isinstance(mask, dict) else None
        gen = self._gen if training else None
        loss = 0.0
        for n in self.topo:
            mk = _arriving_mask(produced, n, mask)
            if produced is not None:
                produced[n.name] = mk
            x = self._gather_input(acts, n)
            if not n.is_layer:
                acts[n.name] = n.node.apply(*x)
                continue
            if n.name in out_names:
                if not hasattr(n.node, "compute_loss"):
                    raise ValueError(
                        f"output {n.name!r} must be an OutputLayer/LossLayer")
                lm = (label_mask.get(n.name) if isinstance(label_mask, dict)
                      else label_mask)
                out_loss = n.node.compute_loss(
                    cparams[n.name], states[n.name], x, labels[n.name],
                    training=training, gen=gen, weights=weights,
                    **self._loss_mask_kw(n, mk, lm, x))
                loss = loss + out_loss.to(
                    torch.promote_types(out_loss.dtype, torch.float32))
                acts[n.name] = x  # terminal; activation unused downstream
            elif carries is not None and n.name in carries:
                seg_mask = (mk if (mk is not None and x.dim() == 3
                                   and tuple(mk.shape[:2])
                                   == tuple(x.shape[:2])) else None)
                x = n.node._maybe_dropout(x, training, gen)
                acts[n.name], new_carries[n.name] = n.node.apply_seq(
                    cparams[n.name], x, carries[n.name], mask=seg_mask,
                    training=training)
            else:
                acts[n.name], new_states[n.name] = n.node.apply(
                    cparams[n.name], states[n.name], x, training=training,
                    gen=gen, **self._mask_kw(n, mk, x))
        if training:
            for n in self.topo:
                if n.is_layer:
                    loss = loss + n.node.regularization(params[n.name])
        return loss, new_states, new_carries

    def _batch(self, features, labels, mask=None, label_mask=None):
        """Inputs/labels as tensors on this graph's device, padded to the
        batch (and sequence) buckets, the 0/1 row weights, and the masks
        as float tensors (one array or a dict by name)."""
        if not isinstance(features, (list, tuple)):
            features = [features]
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        feats = [as_tensor(f, self.device) for f in features]
        labs = [as_tensor(y, self.device) for y in labels]
        mask = _as_mask(mask, self.device)
        label_mask = _as_mask(label_mask, self.device)
        real_n = feats[0].shape[0]
        if self._bucketing is not None:
            feats, labs, mask, label_mask = self._bucketing.pad_graph_batch(
                feats, labs, mask, label_mask)
        weights = dev_weights(self._w_cache, feats[0].shape[0], real_n,
                              self.device)
        return (dict(zip(self.conf.inputs, feats)),
                dict(zip(self.conf.outputs, labs)), weights, mask, label_mask)

    def _gradients(self, inputs, labels, weights, mask=None, label_mask=None,
                   carries=None):
        """(loss, grads, new_states, new_carries) of one training forward +
        backward, leaving params, states and optimizer states as they are.
        Nodes whose updater is NoOp are frozen: their params get no
        gradient. The new states and carries come back detached: a carry
        handed to the next segment starts a new graph."""
        leaves = [(name, path, t) for name, u in self._updaters.items()
                  if not isinstance(u, upd.NoOp)
                  for path, t in tree_items(self.params[name])
                  if t.is_floating_point()]
        for _, _, t in leaves:
            t.requires_grad_(True)
        try:
            with self._kscope():
                loss, new_states, new_carries = self._loss(
                    inputs, labels, weights, mask, label_mask, carries)
                gs = torch.autograd.grad(loss, [t for _, _, t in leaves],
                                         allow_unused=True)
        finally:
            for _, _, t in leaves:
                t.requires_grad_(False)
        grads: Dict[str, dict] = {}
        for (name, path, t), g in zip(leaves, gs):
            tree_set(grads.setdefault(name, {}), path,
                     torch.zeros_like(t) if g is None else g)
        detach = lambda v: v.detach()  # noqa: E731
        new_states = {name: tree_map(detach, s)
                      for name, s in new_states.items()}
        return (loss.detach(), grads, new_states,
                tree_map(detach, new_carries))

    def compute_gradient_and_score(self, features, labels):
        """(grads, score) of one training step on this batch without
        applying it (ComputationGraph.computeGradientAndScore): grads is
        node-name -> {key: tensor}, score the loss as a 0-d tensor. Params,
        states and optimizer states are left as they are."""
        self._check_trainable()
        loss, grads, _, _ = self._gradients(*self._batch(features, labels))
        return grads, loss

    def fit(self, data, labels=None, epochs: int = 1):
        """fit(x, y) | fit([x1, x2], [y1, ...]) | fit(DataSet) |
        fit(iterable of DataSet/MultiDataSet) — :1200 parity. A DataSet's
        masks are shared by every input and output; a MultiDataSet's mask
        lists become dicts by input and output name."""
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
                self._fit_batch(
                    ds.features, ds.labels,
                    mask=_mask_dict(ds, self.conf.inputs, "features_mask",
                                    "features_masks"),
                    label_mask=_mask_dict(ds, self.conf.outputs,
                                          "labels_mask", "labels_masks"))
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

    def _train_body(self, inputs, labels, weights, mask, label_mask):
        """One update, in place; returns the loss."""
        loss, grads, new_states, _ = self._gradients(
            inputs, labels, weights, mask, label_mask)
        self._update(grads, new_states)
        return loss

    def _tbptt_body(self, carries, inputs, labels, weights, mask,
                    label_mask):
        """One segment's update, in place, the carries included; returns
        the loss."""
        loss, grads, new_states, new_carries = self._gradients(
            inputs, labels, weights, mask, label_mask, carries)
        self._update(grads, new_states)
        tree_copy_(carries, new_carries)
        return loss

    def _fit_batch(self, features, labels, mask=None, label_mask=None):
        """One step (:1236): forward, loss, backward, updaters in place;
        the TBPTT segment loop when ``tbptt_length`` cuts the sequence
        (per-sequence 2-D labels cannot be cut: whole-sequence BPTT, as
        the reference's doTruncatedBPTT). ``score_value`` keeps the loss
        as a device tensor (no host sync per step); ``get_score()`` reads
        it. The listeners get the iteration through the dispatcher
        (``:1301-1308``)."""
        self._check_trainable()
        if not isinstance(features, (list, tuple)):
            features = [features]
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        k = self.conf.tbptt_length
        seq = [f for f in features if f.ndim == 3]
        if (k and seq and all(y.ndim == 3 for y in labels)
                and seq[0].shape[1] > k):
            return self._fit_batch_tbptt(features, labels, mask, label_mask)
        args = self._batch(features, labels, mask, label_mask)
        self._step_sizes()
        if capture.enabled():
            loss, _ = self._replay_step(self._aot_steps,
                                        "ComputationGraph.train_step",
                                        self._train_body, args)
        else:
            loss = self._train_body(*args)
        self.iteration += 1
        self.score_value = loss
        self._dispatcher.iteration_done(loss, self.iteration, self.epoch)

    def _init_carries(self, batch_size, dtype):
        """The recurrent layer nodes' zero carries by name (the reference's
        tbpttStateMap)."""
        return {n.name: n.node.init_carry(batch_size, dtype, self.device)
                for n in self.topo if n.is_layer and is_recurrent(n.node)}

    def _fit_batch_tbptt(self, features, labels, mask=None, label_mask=None):
        """The segment loop (``:907-1010``): each k-step segment is one
        update and one iteration, the carries flow forward detached (in the
        compute type), each input's and output's mask is sliced on its own,
        and ``score_value`` is the mean of the segments' losses; the
        listeners are called once, after the last segment (the window
        flushed first). Under bucketing the batch rows pad to their bucket
        once, and each segment pads onto the (B, k) shape
        (``pad_segment``)."""
        k = self.conf.tbptt_length
        dev = self.device
        feats = [as_tensor(f, dev) for f in features]
        labs = [as_tensor(y, dev) for y in labels]
        mask, label_mask = _as_mask(mask, dev), _as_mask(label_mask, dev)
        real_n = feats[0].shape[0]
        bucketing = self._bucketing
        if bucketing is not None:
            npad = bucketing.bucket_batch(real_n)
            if npad != real_n:
                pad = lambda a: BucketingPolicy._pad_axis(a, 0, npad)  # noqa
                feats, labs = [pad(f) for f in feats], [pad(y) for y in labs]
                mask, label_mask = (map_mask(m, pad)
                                    for m in (mask, label_mask))
        weights = dev_weights(self._w_cache, feats[0].shape[0], real_n, dev)
        inputs = dict(zip(self.conf.inputs, feats))
        labels = dict(zip(self.conf.outputs, labs))
        ref = next(f for f in feats if f.dim() == 3)
        carries = self._init_carries(ref.shape[0], self._cast(ref).dtype)

        def seg(d, s):
            return {name: (v[:, s:s + k].contiguous() if v.dim() == 3 else v)
                    for name, v in d.items()}

        losses = []
        for s in range(0, ref.shape[1], k):
            ms = map_mask(mask, lambda m: m[:, s:s + k].contiguous())
            lms = map_mask(label_mask, lambda m: m[:, s:s + k].contiguous())
            seg_in, seg_lab = seg(inputs, s), seg(labels, s)
            if bucketing is not None:
                seg_in, ms, lms = bucketing.pad_segment(seg_in, ms, lms, k)
                seg_lab, _, _ = bucketing.pad_segment(seg_lab, None, None, k)
            self._step_sizes()
            args = (carries, seg_in, seg_lab, weights, ms, lms)
            if capture.enabled():
                # the ragged last segment has a program of its own; the
                # carries flow through the programs' static buffers
                loss, prog = self._replay_step(
                    self._tbptt_steps, "ComputationGraph.tbptt_step",
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
        every bucket before traffic (``:1311-1386``), the graph twin of
        :meth:`MultiLayerNetwork.warmup`. ``shapes``: each entry one shape
        per graph input with the batch (a bare tuple for a single-input
        graph); default the conf's explicit ``batch_buckets`` x
        ``input_shapes``. Returns the number built (none within
        ``capture.disabled()``). ``export_dir`` raises (ROADMAP Queue 1
        item 12)."""
        if export_dir is not None:
            raise NotImplementedError(
                "warmup(export_dir=...) is not ported: the AOT store "
                "(util/aot_store.py, util/compile_cache.py) comes with "
                "ROADMAP Queue 1 item 12")
        if self.device is None:
            raise ValueError("init() the graph before warmup()")
        if shapes is None:
            if self.conf.input_shapes is None:
                raise ValueError(
                    "warmup() needs shapes= or conf.input_shapes")
            if (self._bucketing is None
                    or not isinstance(self._bucketing.batch_buckets, tuple)):
                raise ValueError(
                    "warmup() without shapes= needs explicit batch_buckets "
                    "on the conf (pow2 has no finite bucket list)")
            shapes = [[(b,) + tuple(s) for s in self.conf.input_shapes]
                      for b in self._bucketing.batch_buckets]
        if not capture.enabled():
            return 0  # capture.disabled(): no program is built
        dev = self.device
        built = 0
        for entry in shapes:
            if entry and not isinstance(entry[0], (list, tuple)):
                entry = [entry]  # single-input graph, bare shape
            if len(entry) != len(self.conf.inputs):
                raise ValueError(
                    f"warmup entry has {len(entry)} shapes for "
                    f"{len(self.conf.inputs)} graph inputs")
            b = int(entry[0][0])
            ins = {name: torch.zeros(tuple(int(d) for d in shape),
                                     dtype=dtype, device=dev)
                   for name, shape in zip(self.conf.inputs, entry)}
            if train:
                labs = {name: torch.zeros((b,) + self._shape_of[name],
                                          dtype=torch.float32, device=dev)
                        for name in self.conf.outputs}
                args = (ins, labs, dev_weights(self._w_cache, b, b, dev),
                        None, None)
                if _dispatch_sig(*args) not in self._aot_steps:
                    self._step_sizes()
                    self._program(self._aot_steps, _dispatch_sig(*args),
                                  "ComputationGraph.train_step",
                                  self._train_body, args)
                    built += 1
            if inference:
                key = (False, _dispatch_sig(ins, None))
                if key not in self._aot_forward:
                    self._program(self._aot_forward, key,
                                  "ComputationGraph.forward",
                                  self._forward_program_body(False),
                                  (ins, None), train=False)
                    built += 1
        return built

    # ------------------------------------------------- stateful rnn inference
    def rnn_time_step(self, *inputs):
        """Stateful step-by-step inference over the DAG (rnnTimeStep parity,
        ``:1078``): the recurrent nodes' carries persist across calls.
        Each input is (B, T, F), or (B, F) for one step (then the outputs
        have no time axis). A Bidirectional node raises, as in the
        reference; so does a batch size other than the carried one."""
        if any(n.is_layer and isinstance(n.node, Bidirectional)
               for n in self.topo):
            raise ValueError(
                "rnn_time_step does not support Bidirectional layers")
        self._require_init()
        ins, squeeze = {}, False
        for name, x in zip(self.conf.inputs, inputs):
            x = self._cast(as_tensor(x, self.device))
            if x.dim() == 2:
                squeeze = True
                x = x[:, None]
            ins[name] = x
        first = next(iter(ins.values()))
        carries = self._rnn_carries
        if carries is not None:
            for leaf in tree_leaves(carries):
                if leaf.shape[0] != first.shape[0]:
                    raise ValueError(
                        f"rnn_time_step batch size changed "
                        f"({leaf.shape[0]} -> {first.shape[0]}); call "
                        "rnn_clear_previous_state()")
        else:
            carries = self._init_carries(first.shape[0], first.dtype)
        new_carries = dict(carries)
        with self._kscope(), torch.inference_mode():
            cparams = self._cast_params(self.params)
            acts = dict(ins)
            for n in self.topo:
                x = self._gather_input(acts, n)
                if not n.is_layer:
                    acts[n.name] = n.node.apply(*x)
                elif n.name in carries:
                    acts[n.name], new_carries[n.name] = n.node.apply_seq(
                        cparams[n.name], x, carries[n.name], training=False)
                else:
                    acts[n.name], _ = n.node.apply(
                        cparams[n.name], self.states[n.name], x,
                        training=False)
        self._rnn_carries = new_carries
        outs = [acts[o] for o in self.conf.outputs]
        if squeeze:
            outs = [o[:, -1] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self):
        """rnnClearPreviousState parity (``:1121``)."""
        self._rnn_carries = None

    # ------------------------------------------------------- score, evaluate
    def score(self, dataset=None, x=None, y=None, mask=None,
              label_mask=None) -> float:
        """Inference-mode loss (running batchnorm statistics, no penalty)
        of a batch, as a float (:1546-1612), its masks as ``fit`` takes
        them."""
        self._require_init()
        if dataset is not None:
            x, y = dataset.features, dataset.labels
            if mask is None:
                mask = _mask_dict(dataset, self.conf.inputs, "features_mask",
                                  "features_masks")
            if label_mask is None:
                label_mask = _mask_dict(dataset, self.conf.outputs,
                                        "labels_mask", "labels_masks")
        inputs, labels, weights, mask, label_mask = self._batch(
            x, y, mask, label_mask)
        with self._kscope(), torch.inference_mode():
            loss, _, _ = self._loss(inputs, labels, weights, mask,
                                    label_mask, training=False)
        return float(loss)

    def evaluate(self, iterator) -> Evaluation:
        """Classification metrics of the first output over an iterator of
        DataSets or MultiDataSets (``:1615``); the DataSet's
        ``features_mask`` goes to ``output``, as in the reference."""
        ev = Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            feats = (ds.features if isinstance(ds.features, (list, tuple))
                     else [ds.features])
            preds = self.output(*feats,
                                mask=getattr(ds, "features_mask", None))
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


def _arriving_mask(produced, n, mask):
    """The mask arriving at node ``n`` (``:577``): with per-input dict masks
    each node inherits the first non-None mask among its inputs, and
    vertices pass it on; a shared mask applies everywhere."""
    if produced is None:
        return mask
    return next((produced.get(i) for i in n.inputs
                 if produced.get(i) is not None), None)


def _mask_dict(ds, names, singular: str, plural: str):
    """A batch's masks (``:331``): a DataSet's one mask stays one array; a
    MultiDataSet's mask list becomes a dict by input/output name, so each
    stream keeps its own mask."""
    m = getattr(ds, singular, None)
    if m is not None:
        return m
    ms = getattr(ds, plural, None)
    if not ms:
        return None
    return dict(zip(names, ms))


def _as_mask(m, device):
    """A mask argument (array | dict name->array | None) as float tensors
    on ``device`` (``:320``)."""
    return map_mask(m, lambda v: as_tensor(v, device).float())
