"""Selective rematerialization and stage barriers (counterpart of
deeplearning4j_tpu/util/xla_tuning.py).

A network with a ``remat_policy`` (or ``stage_barriers``) cuts its layers
into stages at its ``stage_boundary`` marks; each stage's forward runs
under :func:`checkpoint_stage`, which keeps the stage's inputs and what the
policy names and lets the backward recompute the rest
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``). The
loss head runs unwrapped. Values and gradients are those of the plain
path; what changes is what the step keeps alive between its forward and
its backward, and what it launches twice.

Policies (the reference's names, :func:`policy_names`):

- ``full``: keep only the stage's inputs; the backward recomputes the whole
  stage, every conv forward included.
- ``save_conv``: also keep each conv output (``tag(x, CONV_OUT)``), so the
  recompute runs the cheap epilogue (batchnorm, activations, adds) and no
  conv forward.
- ``save_conv_dots``: conv outputs and dense products (``DOT_OUT``).
- ``save_dots``: dense products only; convs recompute.
- ``save_all``: keep everything: the stage runs unwrapped, as the
  reference's ``everything_saveable`` recomputes nothing.

Why the policy is not ``torch.utils.checkpoint``'s per-aten-op selective
checkpointing: the conv forward is a hand-written kernel launched through
ctypes inside ``Conv2dFunction``, which no dispatch mode sees, so a policy
keyed on aten ops would quietly recompute every conv. Here the ops that
produce a tagged value ask the stage first (:func:`reuse`): in the
recompute, a conv whose output the policy keeps gets it back from the
stage and launches nothing, while its autograd node is still built (it
saves its input and filter as in the forward), so the recompute saves the
same tensors in the same order as the forward did. ``tag`` records the
value in the forward.

Random draws inside a stage (dropout) are kept the same way
(:func:`draw`): the recompute reuses the forward's draw instead of drawing
again, so the mask is the plain path's and each generator moves once a
step, eager or inside a CUDA graph, with no generator state to put back.
Layer state (the batchnorm's running statistics) comes back from the
stage's forward; the recompute's is thrown away with the rest of its
outputs.

The recompute runs inside the backward, which autograd may run on another
thread: the stage pins the kernel dispatch mode of its forward and
re-enters it there.

``barrier`` is the identity in value and gradient. The reference's
``lax.optimization_barrier`` stops XLA from fusing across a stage
boundary; eager PyTorch and CUDA graphs run each op as its own launch and
fuse nothing, so there is nothing to fence. ``XLA_FLAG_CANDIDATES`` is
kept as data for ``tuning/space.py``'s ``XlaFlagsSpace``, whose every
candidate is invalid here (there is no XLA).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import torch

# Names the ops in ops/nn.py tag their outputs with.
CONV_OUT = "conv_out"
DOT_OUT = "dot_out"

#: a policy that keeps every tensor: the stage runs unwrapped
SAVE_ALL = "save_all"

# name -> factory returning the set of tag names a stage keeps (an empty
# set: recompute everything), or SAVE_ALL (keep everything)
_POLICIES: Dict[str, Optional[Callable[[], object]]] = {
    "full": None,
    "save_conv": lambda: frozenset({CONV_OUT}),
    "save_conv_dots": lambda: frozenset({CONV_OUT, DOT_OUT}),
    "save_dots": lambda: frozenset({DOT_OUT}),
    "save_all": lambda: SAVE_ALL,
}


def policy_names() -> List[str]:
    """Registered policy names ('none' disables wrapping)."""
    return ["none"] + sorted(_POLICIES)


def register_policy(name: str, factory: Optional[Callable[[], object]]):
    """Register a policy: ``factory()`` gives the tag names a stage keeps
    (an iterable of :data:`CONV_OUT`/:data:`DOT_OUT`), or
    :data:`SAVE_ALL`; ``None`` is a full per-stage recompute."""
    _POLICIES[name] = factory
    return factory


def resolve_policy(name: Optional[str]) -> Tuple[bool, object]:
    """(wrap_stages, policy) for a configured policy name.

    ``None``/'none' -> (False, None): stages run unwrapped.
    'full'          -> (True, frozenset()): recompute everything.
    otherwise       -> (True, the factory's tag names or SAVE_ALL).
    """
    if name is None or name == "none":
        return False, None
    try:
        factory = _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown remat policy {name!r}; known: {policy_names()}"
        ) from None
    if factory is None:
        return True, frozenset()
    kept = factory()
    return True, (SAVE_ALL if kept == SAVE_ALL else frozenset(kept))


# --------------------------------------------------------------------------
# the stage frame: what a stage's forward keeps for its recompute
# --------------------------------------------------------------------------

_local = threading.local()


class _Frame:
    """One stage call: the tagged tensors its forward kept (by tag name, in
    the order the ops ran) and its random draws, with the recompute's
    cursors into them."""

    def __init__(self, keep: FrozenSet[str], impl: str):
        self.keep = keep
        self.impl = impl
        self.saved: Dict[str, List[torch.Tensor]] = {n: [] for n in keep}
        self.draws: List[torch.Tensor] = []
        self.mode = "forward"
        self.cursor: Dict[str, int] = {}
        self.draw_cursor = 0


def _frame() -> Optional[_Frame]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def _entered(frame: _Frame, mode: str):
    from deeplearning4j_tpu_torch.ops import kernels as _kern

    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    frame.mode = mode
    if mode == "recompute":
        frame.cursor = {n: 0 for n in frame.keep}
        frame.draw_cursor = 0
    stack.append(frame)
    try:
        with _kern.impl_scope(frame.impl):
            yield
    finally:
        stack.pop()


def tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """Mark ``x`` as a ``name`` output: a stage whose policy keeps ``name``
    records it in its forward. Identity everywhere (outside a stage, in a
    recompute, or when the policy does not keep it)."""
    frame = _frame()
    if frame is not None and frame.mode == "forward" and name in frame.keep:
        frame.saved[name].append(x.detach())
    return x


def keeps(name: str) -> bool:
    """Whether the stage running now (forward or recompute) keeps
    ``name`` outputs."""
    frame = _frame()
    return frame is not None and name in frame.keep


def reuse(name: str) -> Optional[torch.Tensor]:
    """In a stage's recompute, the next ``name`` output its forward kept
    (the op then computes nothing), else None."""
    frame = _frame()
    if frame is None or frame.mode != "recompute" or name not in frame.keep:
        return None
    i = frame.cursor[name]
    frame.cursor[name] = i + 1
    return frame.saved[name][i]


def draw(fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A random draw ``fn()`` inside a stage: drawn in the forward and kept,
    handed back in the recompute (the generator moves once)."""
    frame = _frame()
    if frame is None:
        return fn()
    if frame.mode == "forward":
        t = fn()
        frame.draws.append(t)
        return t
    t = frame.draws[frame.draw_cursor]
    frame.draw_cursor += 1
    return t


def checkpoint_stage(fn: Callable, policy_name: Optional[str]) -> Callable:
    """Wrap one stage function per the named policy: identity for 'none'
    and 'save_all', else the stage runs under a non-reentrant checkpoint
    with its own frame (see the module doc). Outside autograd (no tensor
    argument needs a gradient, or grad mode is off) the stage simply
    runs."""
    wrap, policy = resolve_policy(policy_name)
    if not wrap or policy == SAVE_ALL:
        return fn

    def run(*args):
        from deeplearning4j_tpu_torch.ops import kernels as _kern

        frame = _Frame(policy, _kern.resolve_impl())
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (_entered(frame, "forward"),
                                _entered(frame, "recompute")))

    return run


def barrier(tree):
    """Stage fence: the identity in value and gradient (see the module
    doc: eager CUDA and CUDA graphs have no fusion to fence)."""
    return tree


# --------------------------------------------------------------------------
# XLA flag candidates (tuning/space.py XlaFlagsSpace): kept as data
# --------------------------------------------------------------------------
XLA_FLAG_CANDIDATES: List[Tuple[str, str]] = [
    ("flags:opt_level_2", "--xla_backend_optimization_level=2"),
    ("flags:no_xla_remat", "--xla_disable_hlo_passes=rematerialization"),
    ("flags:tpu_vmem_64M", "--xla_tpu_scoped_vmem_limit_kib=65536"),
    ("flags:tpu_no_latency_sched",
     "--xla_tpu_enable_latency_hiding_scheduler=false"),
]
