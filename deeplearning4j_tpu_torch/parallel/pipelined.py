"""PipelinedTrainer: a network partitioned into pipeline stages, trained in
GPipe microbatches (counterpart of deeplearning4j_tpu/parallel/pipelined.py).

- **Stage partition** (:func:`stage_partition`, reference ``:203``): the
  layers split at the ``stage_boundary()`` marks into ``pipe_stages``
  structurally identical stages, with an optional preamble before and
  postamble after; the loss head always runs outside the pipeline, on the
  whole lane batch. Every precondition the equal-stage contract needs is
  refused loudly, in the reference's words: configs that drift between
  stages, shapes or updaters that differ, too few chunks, a stage holding
  floating-point state (batchnorm), a graph that is not a chain, TBPTT,
  masks, a head that takes no ``weights``.
- **Stacked state**: the stage params, layer states and optimizer state
  stack into one tree with a leading stage axis per stage position
  (``stage:<j>``), beside ``pre:<i>``, ``post:<i>`` and ``head``.
  :meth:`PipelinedTrainer.sync_model` writes it back to the network in its
  own layout (unstack: bit-exact), in place; a write to the network from
  outside the step (a checkpoint restore, a rollback, a transfer) changes
  the version of the tensors it wrote and is adopted at the next step
  (:meth:`PipelinedTrainer._adopt_model_state`).
- **The lane step** (reference ``:684``): the preamble on the whole lane
  batch, the stages over ``n_micro`` microbatches through
  :func:`~deeplearning4j_tpu_torch.parallel.pipeline.gpipe_scan` (each
  stage's params are views of the stacked tensors, so autograd sums every
  microbatch's gradient of a stage into its slice of the stacked
  gradient), the postamble and the loss head on the whole lane batch with
  the 0/1 loss weights of a ragged batch's padding. Then the wrapper's
  combine (the pairwise lane sum, or the compressed exchange) and one
  update, all in one ``nn/capture.Program`` per batch signature in the
  trainer's own table.
- **The pipeline-layout fused engine** (``_convert_buffers`` /
  ``_convert_fused_state``, reference ``:432``/``:460``): a fused network's
  optimizer state converts between the network's engine and one built over
  the stacked tree (a stacked stage tree is a single leaf a position), by
  way of the leaves, so the padding of the flat buffers never shifts an
  element; bit-exact both ways.
- **Remat**: the conf's ``remat_policy`` wraps each stage body in
  ``util/xla_tuning.checkpoint_stage``.

One device: the mesh's ``pipe`` axis is 1 (the reference needs only that
it divide ``pipe_stages``), so the bytes per device are all of the stacked
state and the bubble costs no time (``bubble_fraction`` is the schedule's
arithmetic). ``tp_rules`` need a ``model`` axis of more than one device:
ROADMAP item 10c.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.parallel import gspmd
from deeplearning4j_tpu_torch.parallel.mesh import (TrainingMesh,
                                                    multi_device_error)
from deeplearning4j_tpu_torch.parallel.pipeline import (bubble_fraction,
                                                        gpipe_scan)
from deeplearning4j_tpu_torch.parallel.wrapper import (ParallelWrapper,
                                                       _batch_masks, _lane)
from deeplearning4j_tpu_torch.tree import (tree_copy_, tree_items,
                                           tree_leaves, tree_map, tree_set)
from deeplearning4j_tpu_torch.util import cost_model as cmod
from deeplearning4j_tpu_torch.util import telemetry as tm

# ---------------------------------------------------------------------------
# stage partition
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StagePartition:
    """The network's layers split for pipelining (reference ``:95``):
    ``pre``/``post`` are [(key, layer)] run on the whole lane batch,
    ``stages`` S structurally identical lists of (key, layer), ``head`` the
    loss layer, ``order`` every key in layer order. Keys are layer indices
    (MultiLayerNetwork) or node names (a chain ComputationGraph)."""

    pre: List[Tuple[Any, Any]]
    stages: List[List[Tuple[Any, Any]]]
    post: List[Tuple[Any, Any]]
    head: Tuple[Any, Any]
    order: List[Any]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def per_stage(self) -> int:
        return len(self.stages[0])

    def pp_keys(self) -> List[str]:
        """The pipeline-layout keys, in a stable order."""
        return ([f"pre:{i}" for i in range(len(self.pre))]
                + [f"stage:{j}" for j in range(self.per_stage)]
                + [f"post:{i}" for i in range(len(self.post))]
                + ["head"])


def _linear_chain_items(model) -> List[Tuple[str, Any]]:
    """A ComputationGraph as an ordered (name, layer) chain, or why it
    cannot pipeline (reference ``:124``)."""
    conf = model.conf
    if len(conf.inputs) != 1 or len(conf.outputs) != 1:
        raise ValueError(
            "pipelined fit() supports single-input single-output "
            f"ComputationGraphs (got {len(conf.inputs)} inputs / "
            f"{len(conf.outputs)} outputs)")
    prev = conf.inputs[0]
    items = []
    for n in model.topo:
        if not n.is_layer:
            raise ValueError(
                f"pipelined fit() needs a linear chain of LAYER nodes; "
                f"{n.name!r} is a {type(n.node).__name__} vertex")
        if list(n.inputs) != [prev]:
            raise ValueError(
                f"pipelined fit() needs a linear chain: node {n.name!r} "
                f"consumes {n.inputs} (expected [{prev!r}])")
        items.append((n.name, n.node))
        prev = n.name
    if prev != conf.outputs[0]:
        raise ValueError("the chain's last node must be the graph output")
    return items


def _items_and_bounds(model) -> Tuple[List[Tuple[Any, Any]], List[int]]:
    """(ordered (key, layer) items with the head, stage-start indices from
    the ``stage_boundary()`` marks) (reference ``:151``)."""
    conf = model.conf
    if gspmd.is_graph(model):
        items = _linear_chain_items(model)
        names = [k for k, _ in items]
        bounds = []
        for name in conf.remat_stages or ():
            if name not in names:
                raise ValueError(f"stage boundary {name!r} is not a node")
            # a named node ENDS a stage: the next node starts one
            bounds.append(names.index(name) + 1)
    else:
        items = list(enumerate(model.layers))
        n = len(items)
        bounds = []
        for b in sorted(set(conf.remat_stages or ())):
            if not 0 < b < n:
                raise ValueError(
                    f"stage boundary {b} out of range (1..{n - 1})")
            bounds.append(int(b))
    return items, sorted(set(bounds))


def _updater_sig(model, key) -> str:
    u = model._updaters[key]
    try:
        return repr(u.to_dict())
    except Exception:  # noqa: BLE001 - exotic updater: identity fallback
        return repr(u)


def _layer_cfg(lyr) -> str:
    """A layer's config without its display name (reference ``:184``): the
    identity two stages must share, since every stage runs stage 0's layer
    objects on its own params."""
    try:
        d = dict(lyr.to_dict())
    except Exception:  # noqa: BLE001 - config-less layer: type identity only
        return type(lyr).__name__
    d.pop("name", None)
    return repr(sorted(d.items(), key=lambda kv: kv[0]))


def _leaf_sig(tree):
    return [(path, tuple(t.shape), str(t.dtype))
            for path, t in tree_items(tree)]


def stage_partition(model, pipe_stages: int) -> StagePartition:
    """Partition the network at its ``stage_boundary()`` marks into
    ``pipe_stages`` structurally identical stages plus optional preamble
    and postamble chunks and the loss head (reference ``:203``); loud on
    every violated precondition."""
    S = int(pipe_stages)
    if S < 2:
        raise ValueError(f"pipe_stages must be >= 2, got {S}")
    items, bounds = _items_and_bounds(model)
    if len(items) < 2:
        raise ValueError("pipelining needs at least one body layer + head")
    head = items[-1]
    if not hasattr(head[1], "compute_loss"):
        raise ValueError("last layer must be an OutputLayer/LossLayer")
    body = items[:-1]
    m = len(body)
    bounds = [b for b in bounds if 0 < b < m]  # a bound at the head is inert
    chunks, start = [], 0
    for b in bounds:
        chunks.append(body[start:b])
        start = b
    chunks.append(body[start:])
    if len(chunks) < S:
        raise ValueError(
            f"stage_boundary() markers yield {len(chunks)} chunks; "
            f"pipe_stages={S} needs at least {S} (mark more boundaries)")

    def identical(cands) -> Optional[str]:
        n_layers = len(cands[0])
        if any(len(c) != n_layers for c in cands):
            return f"stage layer counts differ: {[len(c) for c in cands]}"
        for j in range(n_layers):
            ref_k, ref_l = cands[0][j]
            for c in cands[1:]:
                k, lyr = c[j]
                if type(lyr) is not type(ref_l):
                    return (f"stage layer {j}: {type(ref_l).__name__} vs "
                            f"{type(lyr).__name__}")
                if _layer_cfg(lyr) != _layer_cfg(ref_l):
                    return (f"stage layer {j}: layer configs differ "
                            f"({ref_k!r} vs {k!r}: {_layer_cfg(ref_l)} vs "
                            f"{_layer_cfg(lyr)})")
                if _leaf_sig(model.params[k]) != \
                        _leaf_sig(model.params[ref_k]):
                    return (f"stage layer {j}: param shapes/dtypes differ "
                            f"({ref_k!r} vs {k!r})")
                if _updater_sig(model, k) != _updater_sig(model, ref_k):
                    return (f"stage layer {j}: updaters differ "
                            f"({ref_k!r} vs {k!r})")
        return None

    reasons = []
    for pre_k in range(0, len(chunks) - S + 1):
        post_k = len(chunks) - S - pre_k
        cands = chunks[pre_k:pre_k + S]
        why = identical(cands)
        if why is None:
            part = StagePartition(
                pre=[kv for c in chunks[:pre_k] for kv in c],
                stages=[list(c) for c in cands],
                post=[kv for c in chunks[pre_k + S:] for kv in c],
                head=head, order=[k for k, _ in items])
            _validate_stage_state(model, part)
            return part
        reasons.append(f"pre={pre_k}/post={post_k}: {why}")
    raise ValueError(
        f"no {S} consecutive stage_boundary() chunks are structurally "
        f"identical (equal layer stack, param shapes, updaters): "
        + "; ".join(reasons))


def _validate_stage_state(model, part: StagePartition):
    """Stage layers carry no floating-point state (reference ``:281``): the
    pipeline applies a stage once per microbatch, so running statistics
    would advance in schedule order."""
    for chunk in part.stages:
        for k, lyr in chunk:
            for leaf in tree_leaves(model.states[k]):
                if leaf.is_floating_point() or leaf.is_complex():
                    raise ValueError(
                        f"stage layer {k!r} ({type(lyr).__name__}) holds "
                        "floating-point state (running statistics); "
                        "pipeline stages must be stateless — keep such "
                        "layers in the preamble/postamble chunks")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _rebuild(template, leaves):
    """``template``'s structure with ``leaves`` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


class PipelinedTrainer(ParallelWrapper):
    """``ParallelWrapper`` whose step runs the network as pipeline stages
    over microbatches (see the module doc), with the same ``fit`` /
    ``step_batch`` / ``end_epoch`` / ``reshard`` surface.

        conf = (builder.pipe_stages(4).n_micro(4).list()
                ... .stage_boundary() ... )
        net = MultiLayerNetwork(conf).init()
        PipelinedTrainer(net).fit(iterator, epochs=3)
    """

    def __init__(self, model, mesh: Optional[TrainingMesh] = None,
                 pipe_stages: Optional[int] = None,
                 n_micro: Optional[int] = None, tp_rules=None, **kw):
        conf = model.conf
        knobs = conf.knobs
        S = int(pipe_stages if pipe_stages is not None
                else knobs.get("pipe_stages", 0) or 0)
        M = int(n_micro if n_micro is not None
                else knobs.get("n_micro", 0) or 0)
        if S < 2:
            raise ValueError(
                "PipelinedTrainer needs pipe_stages >= 2 (constructor arg, "
                "conf pipe_stages, or DL4J_TPU_PIPE_STAGES)")
        self.pipe_stages = S
        self.n_micro = M if M >= 1 else S
        if conf.tbptt_length:
            raise NotImplementedError(
                "pipelined fit() does not support TBPTT segments; unset "
                "tbptt_length or use ParallelWrapper")
        if getattr(model, "device", None) is None:
            raise ValueError("init() the network before PipelinedTrainer")
        if mesh is None:
            mesh = TrainingMesh(data=1, devices=[model.device])
        if S % mesh.pipe:
            raise ValueError(
                f"pipe mesh axis ({mesh.pipe}) must divide pipe_stages "
                f"({S}) — each pipe group holds a whole number of stages")
        if tp_rules:
            raise multi_device_error(
                "tensor-parallel tp_rules on the stage leaves (a 'model' "
                "axis of more than one device)")
        super().__init__(model, mesh=mesh, **kw)
        self._uses_lanes = True  # the pipelined step is always lanes
        self.part = stage_partition(model, S)
        head_lyr = self.part.head[1]
        if "weights" not in inspect.signature(
                head_lyr.compute_loss).parameters:
            raise ValueError(
                f"loss head {type(head_lyr).__name__} does not accept "
                "per-example weights — required for exact ragged-batch "
                "padding (the 0/1-weight machinery)")
        self._is_graph = gspmd.is_graph(model)
        self._pp: Optional[dict] = None
        self._pp_engine: Optional[upd.FusedUpdateEngine] = None
        self._pp_sizes: Optional[upd.StepSizes] = None
        self._model_ids: Optional[tuple] = None
        self._gen_ref = None
        # the stages' updaters are equal by the partition's contract
        self._pp_updaters = {}
        for i, (k, _) in enumerate(self.part.pre):
            self._pp_updaters[f"pre:{i}"] = model._updaters[k]
        for j, (k, _) in enumerate(self.part.stages[0]):
            self._pp_updaters[f"stage:{j}"] = model._updaters[k]
        for i, (k, _) in enumerate(self.part.post):
            self._pp_updaters[f"post:{i}"] = model._updaters[k]
        self._pp_updaters["head"] = model._updaters[self.part.head[0]]
        self._pp_groups = upd.group_by_rule(self._pp_updaters)
        self._tags = (dict(enumerate(model._layer_tags))
                      if not self._is_graph else dict(model._node_tags))

    # ------------------------------------------------------- tree plumbing
    def _model_keys(self):
        """(pp key, model key) of every unstacked section."""
        part = self.part
        return ([(f"pre:{i}", k) for i, (k, _) in enumerate(part.pre)]
                + [(f"post:{i}", k) for i, (k, _) in enumerate(part.post)]
                + [("head", part.head[0])])

    def _stack_tree(self, model_tree) -> dict:
        """Model layout (a list by layer or a dict by node) -> pipeline
        layout (reference ``:385``): new tensors, the stage positions
        stacked over a leading stage axis."""
        part = self.part
        out = {k: tree_map(lambda t: t.detach().clone(), model_tree[mk])
               for k, mk in self._model_keys()}
        for j in range(part.per_stage):
            per_stage = [model_tree[chunk[j][0]] for chunk in part.stages]
            out[f"stage:{j}"] = tree_map(
                lambda *xs: torch.stack([x.detach() for x in xs]),
                *per_stage)
        return {k: out[k] for k in part.pp_keys()}

    def _unstack_tree(self, pp_tree, like_model_tree):
        """Pipeline layout -> model layout, the container of
        ``like_model_tree`` (reference ``:407``); new tensors, bit-exact."""
        part = self.part
        out = (dict(like_model_tree) if isinstance(like_model_tree, dict)
               else list(like_model_tree))
        for k, mk in self._model_keys():
            out[mk] = tree_map(lambda t: t.detach().clone(), pp_tree[k])
        for si, chunk in enumerate(part.stages):
            for j in range(part.per_stage):
                out[chunk[j][0]] = tree_map(
                    lambda v, _si=si: v[_si].detach().clone(),
                    pp_tree[f"stage:{j}"])
        return out

    # --------------------------------------- fused-engine state conversion
    def _engine_trees(self, engine, bufs, templates):
        """A set of per-group flat buffers of ``engine`` as trees by the
        engine's keys (``templates``: a tree of each key's params)."""
        from deeplearning4j_tpu_torch.ops import updater_ops as uo

        out = {k: [None] * len(tree_leaves(templates[k]))
               for k in engine.keys}
        for g, buf in zip(engine.groups, bufs):
            uo.unflatten_group(g, buf.detach(), out)
        return {k: _rebuild(templates[k], out[k]) for k in engine.keys}

    def _convert_buffers(self, bufs, src_engine, dst_engine, to_pp: bool):
        """A full set of per-group flat buffers converted between the
        network's engine and the pipeline-layout engine (reference
        ``:432``): unflatten into leaves, stack or unstack, flatten again.
        An element permutation, bit-exact; each buffer's padding is zeros,
        as a fresh engine's."""
        from deeplearning4j_tpu_torch.ops import updater_ops as uo

        model = self.model
        if to_pp:
            src_tpl = model.params if isinstance(model.params, dict) \
                else dict(enumerate(model.params))
            trees = self._engine_trees(src_engine, bufs, src_tpl)
            full = (dict(model.params) if isinstance(model.params, dict)
                    else list(model.params))
            for k, t in trees.items():
                full[k] = t
            dst = self._stack_tree(full)
        else:
            trees = self._engine_trees(src_engine, bufs, self._pp["params"])
            full = {k: trees.get(k, v)
                    for k, v in self._pp["params"].items()}
            dst = self._unstack_tree(full, model.params)
            if not isinstance(dst, dict):
                dst = dict(enumerate(dst))
        leaves = {k: tree_leaves(dst[k]) for k in dst_engine.keys}
        return [uo.flatten_group(g, leaves, cast_dtype=torch.float32)
                for g in dst_engine.groups]

    def _convert_fused_state(self, state, src_engine, dst_engine,
                             to_pp: bool) -> dict:
        """A ``FusedUpdateEngine`` state (resident masters, each rule's
        moments, the loss-scale automaton) converted between layouts
        (reference ``:460``); groups matched by (rule, dtype)."""
        from deeplearning4j_tpu_torch.ops import updater_ops as uo

        def gkey(g):
            return (uo.updater_signature(g.updater), str(g.dtype))

        src_idx = {gkey(g): i for i, g in enumerate(src_engine.groups)}
        src_states = state["groups"]
        masters = self._convert_buffers(
            [gs["master"] for gs in src_states], src_engine, dst_engine,
            to_pp)
        slots = []
        for gs in src_states:
            for s in (gs["opt"] or {}):
                if s not in slots:
                    slots.append(s)
        slot_out = {}
        for s in slots:
            bufs = [gs["opt"][s] if s in (gs["opt"] or {}) else
                    torch.zeros_like(gs["master"]) for gs in src_states]
            slot_out[s] = self._convert_buffers(bufs, src_engine,
                                                dst_engine, to_pp)
        groups = []
        for dj, dg in enumerate(dst_engine.groups):
            src_opt = src_states[src_idx[gkey(dg)]]["opt"]
            opt = ({s: slot_out[s][dj] for s in src_opt}
                   if isinstance(src_opt, dict) else src_opt)
            groups.append({"master": masters[dj], "opt": opt})
        out = {"groups": groups}
        if "scale" in state:
            out["scale"] = tree_map(lambda t: t.detach().clone(),
                                    state["scale"])
        return out

    # ------------------------------------------------------- live state
    def _model_ids_now(self) -> tuple:
        """The identity and version of every tensor of the network's
        state (reference ``:560``): a write from outside the step, in place
        (a checkpoint restore) or by rebinding (an importer), changes it."""
        m = self.model
        return tuple((id(t), t._version)
                     for tree in (m.params, m.states, m.opt_states)
                     for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor))

    def _build_pp_state(self):
        """(Re)build the pipeline-layout state from the network's
        (reference ``:573``): at the first build, then after any write from
        outside. Later builds copy into the resident tensors, so the
        programs captured on them stay valid."""
        model = self.model
        engine = getattr(model, "_fused", None)
        params = self._stack_tree(model.params)
        states = self._stack_tree(model.states)
        if engine is not None:
            if self._pp_engine is None:
                k = model.conf.knobs
                self._pp_engine = upd.FusedUpdateEngine(
                    self._pp_updaters, params,
                    loss_scale=k.get("loss_scale", "none"),
                    loss_scale_value=k.get("loss_scale_value", 2.0 ** 15),
                    growth_interval=k.get("loss_scale_growth", 2000))
                self._pp_engine.init_state(params)  # its static scale
            opts = self._convert_fused_state(model.opt_states, engine,
                                             self._pp_engine, to_pp=True)
        else:
            opts = self._stack_tree(model.opt_states)
        fresh = {"params": params, "states": states, "opts": opts}
        if self._pp is None:
            self._pp = fresh
        else:
            with torch.no_grad():
                tree_copy_(self._pp, fresh)
        if self._pp_sizes is None:
            groups = (self._pp_engine.rule_groups if self._pp_engine
                      is not None else self._pp_groups)
            self._pp_sizes = upd.StepSizes(groups, model.device)
        self._model_ids = self._model_ids_now()

    def sync_model(self):
        """Write the live pipeline-layout state back into the network's own
        tensors (reference ``:623``): unstacked, bit-exact; a fused
        network's engine state converted back with its masters, so params
        and masters move together. Checkpoints, archives and the elastic
        runtime read the network after this."""
        if self._pp is None:
            return
        model = self.model
        with torch.no_grad():
            tree_copy_(model.params, self._unstack_tree(self._pp["params"],
                                                        model.params))
            tree_copy_(model.states, self._unstack_tree(self._pp["states"],
                                                        model.states))
            engine = getattr(model, "_fused", None)
            if engine is not None:
                tree_copy_(model.opt_states, self._convert_fused_state(
                    self._pp["opts"], self._pp_engine, engine, to_pp=False))
            else:
                tree_copy_(model.opt_states, self._unstack_tree(
                    self._pp["opts"], model.opt_states))
        model._cast_cache.clear()
        self._model_ids = self._model_ids_now()

    def _adopt_model_state(self):
        """At every step (reference ``:652``): re-stack when the network's
        state was written from outside; free when nothing changed."""
        if self._pp is None or self._model_ids != self._model_ids_now():
            self._build_pp_state()

    # --------------------------------------------------------------- build
    def _build(self):
        if not self.model.params:
            raise ValueError("model must be init()ed first")
        self._build_pp_state()
        if self._compressor is not None:
            self._place_compression_state()
        self._publish_layout()
        self._built = True

    def _comp_template(self):
        """ONE worker's gradient template in pipeline layout: the
        pipeline-layout engine's flat buffers, else the stacked gradient
        tree (reference ``:211``)."""
        model = self.model
        if self._pp_engine is not None:
            return [torch.zeros(g.total, dtype=torch.float32,
                                device=model.device)
                    for g in self._pp_engine.groups]
        return self._grad_template()

    def _grad_template(self) -> dict:
        out: dict = {}
        for k in self._grad_keys():
            for path, t in tree_items(self._pp["params"][k]):
                if t.is_floating_point():
                    tree_set(out.setdefault(k, {}), path, torch.zeros(
                        t.shape, dtype=torch.float32, device=t.device))
        return out

    def _grad_keys(self) -> List[str]:
        return [k for k in self.part.pp_keys()
                if not isinstance(self._pp_updaters[k], upd.NoOp)]

    def _state_trees(self):
        pp = self._pp
        return [pp["params"], pp["states"], pp["opts"], self._comp_state]

    def _check_programs(self):
        """The programs read the resident pipeline-layout tensors, which
        are only ever written in place, and draw from the network's dropout
        generator: a new generator (a re-``init``) drops them."""
        if self.model._gen is not self._gen_ref:
            self._drop()
            self._gen_ref = self.model._gen

    # ------------------------------------------------------------ lane body
    def _resolve_remat(self) -> Optional[str]:
        policy = self.model.conf.knobs.get("remat_policy")
        return None if policy in (None, "none") else policy

    def _pipe_loss(self, pp_params, pp_states, x, y, weights):
        """The lane's training loss (reference ``pipe_loss``): preamble,
        the GPipe schedule over ``n_micro`` microbatches, postamble, loss
        head, penalty. Returns (loss in fp32, new states)."""
        from deeplearning4j_tpu_torch.util import xla_tuning as _xt

        model, part, tags = self.model, self.part, self._tags
        gen = model._gen
        cast = model._cast
        cp = {k: tree_map(cast, v) for k, v in pp_params.items()}
        h = cast(x)
        new_states = dict(pp_states)
        for i, (k, lyr) in enumerate(part.pre):
            with cmod.layer_scope(tags[k]):
                h, new_states[f"pre:{i}"] = lyr.apply(
                    cp[f"pre:{i}"], pp_states[f"pre:{i}"], h, training=True,
                    gen=gen)
        M, L = self.n_micro, part.per_stage
        mb = h.shape[0] // M
        micro = h.reshape((M, mb) + tuple(h.shape[1:]))
        stage_layers = [lyr for _, lyr in part.stages[0]]

        def stage_apply(packed, xm):
            sp, ss = packed
            hh = xm
            for j, lyr in enumerate(stage_layers):
                hh, _ = lyr.apply(sp[j], ss[j], hh, training=True, gen=gen)
            return hh

        policy = self._resolve_remat()
        body = (stage_apply if policy is None
                else _xt.checkpoint_stage(stage_apply, policy))
        packed = ([cp[f"stage:{j}"] for j in range(L)],
                  [pp_states[f"stage:{j}"] for j in range(L)])
        with cmod.layer_scope("pipe_stages"):
            outs = gpipe_scan(body, packed, micro)
        h = outs.reshape((M * mb,) + tuple(outs.shape[2:]))
        for i, (k, lyr) in enumerate(part.post):
            with cmod.layer_scope(tags[k]):
                h, new_states[f"post:{i}"] = lyr.apply(
                    cp[f"post:{i}"], pp_states[f"post:{i}"], h,
                    training=True, gen=gen)
        head_key, head_lyr = part.head
        with cmod.layer_scope(tags[head_key]):
            loss = head_lyr.compute_loss(cp["head"], pp_states["head"], h, y,
                                         training=True, gen=gen,
                                         weights=weights)
        loss = loss.to(torch.promote_types(loss.dtype, torch.float32))
        for i, (k, lyr) in enumerate(part.pre):
            loss = loss + lyr.regularization(pp_params[f"pre:{i}"])
        for j in range(L):
            # a stacked leaf: one reduction over all S stages
            loss = loss + part.stages[0][j][1].regularization(
                pp_params[f"stage:{j}"])
        for i, (k, lyr) in enumerate(part.post):
            loss = loss + lyr.regularization(pp_params[f"post:{i}"])
        loss = loss + head_lyr.regularization(pp_params["head"])
        return loss, new_states

    def _pipe_lane(self, x, y, weights):
        """One lane's (loss, weight mass), (new states, gradients) in
        pipeline layout; under loss scaling the gradients are the scaled
        loss's and the loss returned is not."""
        model = self.model
        pp = self._pp
        leaves = [(k, path, t) for k in self._grad_keys()
                  for path, t in tree_items(pp["params"][k])
                  if t.is_floating_point()]
        for _, _, t in leaves:
            t.requires_grad_(True)
        engine = self._pp_engine
        scale = None if engine is None else engine.current_scale(pp["opts"])
        try:
            with model._kscope():
                loss, new_states = self._pipe_loss(pp["params"], pp["states"],
                                                   x, y, weights)
                scaled = loss if scale is None else loss * scale.to(
                    loss.dtype)
                gs = torch.autograd.grad(scaled, [t for _, _, t in leaves],
                                         allow_unused=True)
        finally:
            for _, _, t in leaves:
                t.requires_grad_(False)
        grads: dict = {}
        for (k, path, t), g in zip(leaves, gs):
            tree_set(grads.setdefault(k, {}), path,
                     torch.zeros_like(t) if g is None else g)
        new_states = {k: tree_map(lambda v: v.detach(), s)
                      for k, s in new_states.items()}
        return (loss.detach(), weights.sum()), (new_states, grads)

    def _lane_body(self, x, y, w, fm=None, lm=None):
        """One pipelined step: R lanes, each through the schedule, then the
        wrapper's combine and one update, in place. Returns (loss,
        stats)."""
        losses, wsums, states_l, grads_l = [], [], [], []
        for r in range(self.replicas):
            (loss, ws), (ns, g) = self._pipe_lane(_lane(x, r), _lane(y, r),
                                                  w[r])
            losses.append(loss)
            wsums.append(ws)
            states_l.append(ns)
            grads_l.append(g)
        return self._combine_update(losses, wsums, states_l, grads_l)

    # wrapper hooks: the combine updates the pipeline-layout state
    def _update_engine(self):
        return self._pp_engine

    def _apply_combined(self, grads, flat: bool) -> None:
        pp, engine = self._pp, self._pp_engine
        sizes = self._pp_sizes.views
        with cmod.optimizer_scope():
            if flat:
                engine.apply_flat(pp["params"], grads, pp["opts"], sizes)
            elif engine is not None:
                engine.apply(pp["params"], grads, pp["opts"], sizes)
            else:
                upd.step_groups(self._pp_groups, pp["params"], grads,
                                pp["opts"], sizes)

    def _live_states(self):
        return self._pp["states"]

    # ------------------------------------------------------------ stepping
    def _shard(self, x, y):
        if self._is_graph:
            x = x[0] if isinstance(x, (list, tuple)) else x
            y = y[0] if isinstance(y, (list, tuple)) else y
        return self.mesh.pad_lane_batch(x, y, self.replicas,
                                        micro=self.n_micro)

    def step_batch(self, ds):
        """ONE pipelined train step on a DataSet (reference ``:936``);
        returns the loss as a device tensor."""
        if not self._built:
            self._build()
        self._adopt_model_state()
        self._adopt_compression_state()
        model = self.model
        fm, lm = _batch_masks(ds, model)
        if any(m is not None for m in tree_leaves([fm, lm])):
            raise NotImplementedError(
                "pipelined fit() does not thread sequence masks; use "
                "ParallelWrapper for masked batches")
        x, y, w = self._shard(ds.features, ds.labels)
        self._check_programs()
        self._pp_sizes.write(model.iteration)
        t0 = time.time_ns()
        with tm.span("parallel.pipe_step", iteration=model.iteration,
                     stages=self.pipe_stages, n_micro=self.n_micro):
            loss, stats, _ = self._run(
                self._programs, "PipelinedTrainer.pipe_step",
                self._lane_body, (x, y, w, None, None))
        if stats is not None:
            self._comp_stats = stats
        model.score_value = loss
        model.iteration += 1
        tm.counter("train.steps_total", model="pipelined")
        if (self.skew_every and tm.enabled()
                and model.iteration % self.skew_every == 0):
            self._probe_replica_skew(loss, t0)
            self._publish_compression_stats()
        model._dispatcher.iteration_done(loss, model.iteration, model.epoch)
        return loss

    # ---------------------------------------------------- memory and layout
    def param_bytes_per_device(self) -> int:
        """Bytes of params the device holds (reference ``:974``): on one
        device, every stage's."""
        if self._pp is None:
            self._build()
        return gspmd.tree_bytes_per_device(self._pp["params"])

    def opt_state_bytes_per_device(self) -> int:
        if self._pp is None:
            self._build()
        return gspmd.tree_bytes_per_device(self._pp["opts"])

    def train_state_bytes_per_device(self) -> int:
        """Params plus optimizer state, per device."""
        return self.param_bytes_per_device() \
            + self.opt_state_bytes_per_device()

    @property
    def bubble_fraction(self) -> float:
        return bubble_fraction(self.pipe_stages, self.n_micro)

    def _publish_layout(self):
        """The layout gauges and table (reference ``:997``)."""
        mesh = self.mesh
        self._publish_mesh_gauges()
        tm.gauge("parallel.pipe_stages", self.pipe_stages)
        tm.gauge("parallel.pipeline_n_micro", self.n_micro)
        tm.gauge("parallel.pipeline_bubble_fraction", self.bubble_fraction)
        tm.gauge("parallel.opt_state_bytes_per_device",
                 self.opt_state_bytes_per_device())
        tm.gauge("parallel.param_bytes_per_device",
                 self.param_bytes_per_device())
        comp = self._compressor
        self.layout = {
            "signature": mesh.layout_signature(
                extra=("pipe", self.pipe_stages, self.n_micro,
                       self.zero_optimizer, self.replicas,
                       (comp.scheme, comp.hosts) if comp else None)),
            "params": gspmd.describe_shardings(self._pp["params"]),
            "opt_states": gspmd.describe_shardings(self._pp["opts"]),
            "pipeline": {
                "stages": self.pipe_stages,
                "n_micro": self.n_micro,
                "bubble_fraction": self.bubble_fraction,
                "layers_per_stage": self.part.per_stage,
                "pre": [str(k) for k, _ in self.part.pre],
                "post": [str(k) for k, _ in self.part.post],
            },
        }
        if comp is not None:
            tm.gauge("parallel.grad_compression_hosts", comp.hosts)
            self.layout["grad_compression"] = {
                "scheme": comp.scheme, "hosts": comp.hosts,
                "residual": gspmd.describe_shardings(
                    self._comp_state["residual"])}

    def reshard(self, mesh: Optional[TrainingMesh] = None):
        """The elastic regroup's hook (reference ``:1033``): the stacked
        state synced back to the network, then rebuilt on ``mesh`` (one
        device: the same tensors, bit-exact)."""
        self.sync_model()
        if mesh is None:
            mesh = TrainingMesh(data=1, devices=[self.model.device])
        if mesh.device != self.model.device:
            raise ValueError(f"reshard to {mesh.device}: the port keeps a "
                             f"network on its device ({self.model.device})")
        if self.pipe_stages % mesh.pipe:
            raise ValueError(
                f"pipe mesh axis ({mesh.pipe}) must divide pipe_stages "
                f"({self.pipe_stages})")
        self.mesh = mesh
        self._drop()
        self._build()
        tm.counter("parallel.reshards_total")
        return self

    def warmup(self, batch_sizes, input_shape=None, label_shape=None) -> int:
        """Build the pipelined step's program for each global batch size
        before the first batch (reference ``:1076``); the capture puts
        back every tensor its warm-up runs touched."""
        from deeplearning4j_tpu_torch.nn import capture
        from deeplearning4j_tpu_torch.parallel.wrapper import lane_program

        if not self._built:
            self._build()
        model = self.model
        in_shape = tuple(input_shape or self._conf_input_shape() or ())
        if not in_shape:
            raise ValueError("warmup() needs input_shape "
                             "(or conf.input_shape)")
        out_shape = tuple(label_shape
                          or getattr(model, "_output_shape", None) or ())
        if not out_shape:
            raise ValueError("warmup() needs label_shape")
        if not capture.enabled():
            return 0
        self._check_programs()
        primed = 0
        for b in batch_sizes:
            x = torch.zeros((int(b),) + in_shape, device=model.device)
            y = torch.zeros((int(b),) + out_shape, device=model.device)
            x, y, w = self.mesh.pad_lane_batch(x, y, self.replicas,
                                               micro=self.n_micro)
            args = (x, y, w, None, None)
            key = capture.dispatch_sig(*args)
            if key in self._programs:
                continue
            self._pp_sizes.write(model.iteration)
            lane_program(model, self._programs, key,
                         "PipelinedTrainer.pipe_step", self._lane_body, args,
                         self._state_trees(), owner=self)
            primed += 1
        return primed

    def _conf_input_shape(self):
        conf = self.model.conf
        shape = getattr(conf, "input_shape", None)
        if shape is None:
            shapes = getattr(conf, "input_shapes", None)
            shape = shapes[0] if shapes else None
        return shape

    # --------------------------------------------------------- cost report
    def cost_report(self, batch_size=None, *, shape=None,
                    dtype=torch.float32, name: str = "pipelined",
                    publish: bool = True):
        """Per-layer cost table of ONE pipelined step (reference ``:1130``):
        one eager step counted on copies of the state (``source:
        counted``), the stages' one ``pipe_stages`` scope split into S
        equal rows ``pipe:stage<i>`` (the stages are identical by
        contract)."""
        from deeplearning4j_tpu_torch.nn import capture

        model = self.model
        if not self._built:
            self._build()
        if shape is None:
            in_shape = self._conf_input_shape()
            if in_shape is None:
                raise ValueError("cost_report() needs shape= or "
                                 "conf.input_shape")
            shape = ((int(batch_size or self.replicas * self.n_micro),)
                     + tuple(in_shape))
        shape = tuple(int(d) for d in shape)
        b, R = shape[0], self.replicas
        if b % (R * self.n_micro):
            raise ValueError(
                f"global batch {b} must divide lanes*n_micro "
                f"({R}*{self.n_micro})")
        self.sync_model()
        shadow = model._cost_shadow()
        twin = PipelinedTrainer(
            shadow, mesh=self.mesh, pipe_stages=self.pipe_stages,
            n_micro=self.n_micro, replicas=R,
            grad_compression=self._compressor, skew_every=0)
        if self._comp_state is not None:
            shadow._grad_comp_state = tree_map(lambda v: v.clone(),
                                               self._comp_state)
        twin._build()
        out_shape = (b,) + tuple(getattr(model, "_output_shape", ()) or ())
        (x,), (y,) = cmod.random_batch(model.device, [shape], [out_shape],
                                       dtype)
        x, y, w = self.mesh.pad_lane_batch(x, y, R, micro=self.n_micro)
        params = (model.params if isinstance(model.params, dict)
                  else dict(enumerate(model.params)))
        params_by_tag = {self._tags[k]: int(sum(
            v.numel() for v in tree_leaves(params[k])))
            for k, _ in self.part.pre + self.part.post + [self.part.head]}
        stage_params = int(sum(
            v.numel() for j in range(self.part.per_stage)
            for v in tree_leaves(self._pp["params"][f"stage:{j}"])))
        with capture.disabled():
            twin._pp_sizes.write(shadow.iteration)
            rec = cmod.count_step(
                lambda: twin._lane_body(x, y, w, None, None))
        rows = self._split_stage_rows(
            cmod.rows_from_counts(rec.by_key, params_by_tag), stage_params)
        report = cmod.CostReport(
            rows=rows, totals={
                "flops": sum(r.flops for r in rows),
                "transcendentals": sum(r.transcendentals for r in rows),
                "bytes_accessed": sum(r.bytes_accessed for r in rows)},
            batch=b, params_total=model.num_params(), source="counted",
            model=str(name),
            peak_flops=cmod.peak_flops_from_env(
                getattr(model.conf, "compute_dtype", None)),
            uncounted_ops=dict(rec.uncounted), kernels=dict(rec.kernels),
            devices=self.mesh.n_devices)
        if publish:
            cmod.publish_report(str(name), report)
        return report

    def _split_stage_rows(self, rows, stage_params_total: int):
        """The one ``pipe_stages`` row as S equal rows ``pipe:stage<i>``
        (reference ``:1245``)."""
        S = self.pipe_stages
        out = []
        for row in rows:
            if row.layer != "pipe_stages":
                out.append(row)
                continue
            for si in range(S):
                out.append(cmod.CostRow(
                    layer=f"pipe:stage{si}",
                    params=stage_params_total // S,
                    flops_fwd=row.flops_fwd / S,
                    flops_bwd=row.flops_bwd / S,
                    transcendentals=row.transcendentals / S,
                    bytes_accessed=row.bytes_accessed / S,
                    source=row.source))
        return out
