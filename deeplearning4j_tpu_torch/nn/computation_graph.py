"""ComputationGraph — DAG network (counterpart of
deeplearning4j_tpu/nn/computation_graph.py), inference path.

The configuration, its JSON and the GraphBuilder DSL mirror the reference
(``ComputationGraphConfiguration`` :59, ``GraphBuilder`` :221). The runtime
walks the topological order eagerly in PyTorch: each layer's ``apply`` on
the node's gathered input, each vertex's ``apply`` on its inputs. A layer
node with several inputs gets the implicit feature-axis merge, as in the
reference.

``compute_dtype="bfloat16"`` casts the inputs and the params (not the
batchnorm running statistics) to bf16 for the forward, as the reference's
``_cast``/``_cast_params`` do (:553-568).

Not ported yet: ``fit`` and the loss/score/evaluate paths (the training
slice), masks and TBPTT (the recurrent slice), SharedLayer, remat stages.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import vertices as V
from deeplearning4j_tpu_torch.nn.conf import (INERT_KNOBS, Builder,
                                              _buckets_from_json,
                                              _buckets_to_json, _detuple,
                                              kernel_impl_from_json,
                                              kernel_impl_to_json)
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
    """DAG network runtime (ComputationGraph.java parity), inference only.
    ``params``/``states`` are dicts node-name -> dict of tensors, keyed as
    the reference keys them."""

    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.topo = conf.topological_order()
        self.params: Dict[str, dict] = {}
        self.states: Dict[str, dict] = {}
        self.device: Optional[torch.device] = None
        self._cast_cache: Dict[Tuple[str, str], tuple] = {}
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

    def _as_input(self, x) -> torch.Tensor:
        """numpy or tensor -> tensor on this graph's device. float64 turns
        into float32, as ``jnp.asarray`` does with x64 off."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(self.device)

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
        ``train=True`` needs training-mode batchnorm (training slice)."""
        self._require_init()
        ins = [self._as_input(x) for x in inputs]
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
        ins = dict(zip(self.conf.inputs, [self._as_input(x) for x in inputs]))
        return self._forward(self.params, self.states, ins)
