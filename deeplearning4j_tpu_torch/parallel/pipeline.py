"""GPipe microbatched stage execution (counterpart of
deeplearning4j_tpu/parallel/pipeline.py).

S structurally identical stages run over ``n_micro`` microbatches in the
classic GPipe fill-drain schedule: ``n_micro + S - 1`` ticks, at tick ``t``
stage ``s`` works on microbatch ``t - s``. The stage params carry a leading
stage axis (:func:`stack_stage_params`).

The reference's tick loop vmaps the stage over the stacked axis and
computes every stage on every tick, the fill and drain ticks on zeros whose
outputs it throws away (``:112-131``). On one device the port runs only the
valid (stage, microbatch) pairs, in schedule order, and banks the last
stage's outputs in microbatch order: the banked outputs are the
reference's, with ``S * n_micro`` stage calls instead of
``S * (n_micro + S - 1)``. Each stage reads its params as views of the
stacked tensors (``unbind`` once per call), so autograd sums every
microbatch's gradient of a stage into that stage's slice of the stacked
gradient.

:func:`bubble_fraction` stays the schedule's arithmetic,
``(S - 1) / (n_micro + S - 1)``. On one device the stages run one after
another on one stream, so the bubble costs no time there; the number says
what a placement of one stage per device would idle.

``pipeline_forward`` pads a batch that ``n_micro`` does not divide by
repeating its last row and slices the padded rows off the result, as the
reference does. Its mesh argument is the port's one-device
``TrainingMesh``; a ``pipe`` axis over several devices is ROADMAP item 10c.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map


def stack_stage_params(params_list: Sequence):
    """[per-stage tree] -> one tree with a leading stage axis (reference
    ``:57``)."""
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def bubble_fraction(stages: int, n_micro: int) -> float:
    """The fill-drain schedule's idle fraction (reference ``:63``): of the
    ``n_micro + S - 1`` ticks each stage is live for, ``S - 1`` are fill
    and drain, identically for the backward."""
    s, m = int(stages), int(n_micro)
    if s < 1 or m < 1:
        raise ValueError(f"stages ({s}) and n_micro ({m}) must be >= 1")
    return (s - 1) / (m + s - 1)


def schedule(stages: int, n_micro: int) -> List[Tuple[int, int, int]]:
    """The valid (tick, stage, microbatch) triples of the GPipe schedule,
    in the order the port runs them: tick by tick, stage 0 first."""
    return [(t, s, t - s) for t in range(n_micro + stages - 1)
            for s in range(stages) if 0 <= t - s < n_micro]


def _per_stage(stacked, s_count: int) -> list:
    """The stacked tree as ``s_count`` trees of views, one ``unbind`` a
    leaf."""
    views = {id(leaf): leaf.unbind(0) for leaf in tree_leaves(stacked)}
    return [tree_map(lambda leaf, _s=s: views[id(leaf)][_s], stacked)
            for s in range(s_count)]


def gpipe_scan(stage_fn: Callable, stacked_params, micro,
               constrain: Optional[Callable] = None):
    """The GPipe tick loop (reference ``:76``), differentiable.

    ``stage_fn(stage_params, x) -> y`` maps a microbatch to one of the same
    shape; ``stacked_params`` is a tree whose leaves share a leading stage
    axis S; ``micro`` is ``(n_micro, mb, ...)``. Returns ``(n_micro, mb,
    ...)``, the sequential application of the S stages to each microbatch.
    ``constrain`` (the reference's sharding hook) is applied to each
    activation that moves between stages; one device needs none."""
    leading = {leaf.shape[0] for leaf in tree_leaves(stacked_params)}
    if len(leading) != 1:
        raise ValueError(
            f"stacked_params leading dims differ: {sorted(leading)} — every "
            "leaf needs the same leading stage axis (stack_stage_params)")
    (s_count,) = leading
    n_micro = micro.shape[0]
    pin = constrain or (lambda t: t)
    stages = _per_stage(stacked_params, s_count)
    # what stage s made of microbatch m, until stage s + 1 takes it on the
    # next tick (the reference's rolled buffer)
    arrived: dict = {}
    outs: list = [None] * n_micro
    for _, s, m in schedule(s_count, n_micro):
        inp = micro[m] if s == 0 else arrived.pop((s - 1, m))
        out = pin(stage_fn(stages[s], inp))
        if s == s_count - 1:
            outs[m] = out
        else:
            arrived[(s, m)] = out
    return torch.stack(outs)


def pipeline_forward(stage_fn: Callable, stacked_params, x, n_micro: int,
                     mesh=None, axis_name: str = "model"):
    """Run x (batch, ...) through the pipelined stages, microbatched
    (reference ``:156``). A batch that ``n_micro`` does not divide pads its
    last microbatch by repeating the final row; the padded rows are sliced
    off the result. ``mesh``: a one-device ``TrainingMesh`` or None."""
    if mesh is not None and getattr(mesh, "n_devices", 1) > 1:
        from deeplearning4j_tpu_torch.parallel.mesh import multi_device_error

        raise multi_device_error(f"a {axis_name!r} pipeline over "
                                 f"{mesh.n_devices} devices")
    b = x.shape[0]
    pad = (n_micro - b % n_micro) % n_micro
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    mb = (b + pad) // n_micro
    micro = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    outs = gpipe_scan(stage_fn, stacked_params, micro)
    return outs.reshape((b + pad,) + tuple(outs.shape[2:]))[:b]


def sequential_reference(stage_fn: Callable, params_list: Sequence, x):
    """The semantics the pipeline matches (reference ``:184``)."""
    h = x
    for p in params_list:
        h = stage_fn(p, h)
    return h
