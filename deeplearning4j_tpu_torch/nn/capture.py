"""Captured programs: the port's counterpart of the reference's jitted,
donated executables, the train step (``nn/multilayer.py:421-441``,
``nn/computation_graph.py:1135-1143``), the TBPTT segment step
(``nn/multilayer.py:478-521``, ``nn/computation_graph.py:906-935``) and
the inference forward (``nn/multilayer.py:179-180``,
``nn/computation_graph.py:533-534``).

A :class:`Program` is one of those for one network at one shape signature
(the reference's ``_dispatch_sig``): static input buffers, and a body that
reads them together with the network's params, layer states, optimizer
states and step sizes, and updates those in place. A call copies its
arguments into the static buffers and replays the body's CUDA graph; what
it returns are the graph's own output tensors, which the next replay
overwrites, so a caller copies what it keeps.

Building a program (the first batch of a signature, or ``warmup``):

- the watcher notes one trace under the reference's function name
  (``util/compile_watcher.py``);
- on CUDA, the body runs :data:`WARMUP_RUNS` times on a side stream (it
  builds the kernels and their plans, makes cuBLAS's handles and
  workspaces, and warms the allocator), on copies that are thrown away:
  everything the body updates in place (``state``: the params, layer and
  optimizer states; and the static inputs) is put back afterwards, and so
  is each dropout generator's state. No update is lost or doubled, and
  the iteration count and the generators' draws come out as an eager
  run's. Then, with dead networks collected and the cache emptied (as
  ``torch.cuda.graph`` does) and the cyclic collector off until it ends,
  the body is captured into the network's graph pool (one
  ``torch.cuda.graph_pool_handle()`` a network, shared by its programs),
  with each generator registered on the graph
  (``CUDAGraph.register_generator_state``), so every replay draws what the
  eager step would draw and moves the generator on as far. The launch
  counters (``ops/kernels``) are put back as they were before the warm-up:
  its launches are thrown away with its updates, and the capture's ran
  nothing; what the capture counted is added again at each replay, so the
  tables count the launches of the steps the network took;
- on the CPU nothing is captured: the caller asked for the CPU, and each
  call runs the body eagerly on the same static buffers.

A capture that fails raises :class:`CaptureError`, naming the function,
the signature and the operation that broke the capture (a host sync such
as ``.item()``, say); nothing carries on eagerly. The generators a failed
capture had registered (the default CUDA generator among them) are given
back their state from before it, so eager work can go on.
:func:`disabled` is the counterpart of ``jax.disable_jit()``: within it
the networks run each step eagerly, with no program, on every thread of
the process (a server's scheduler thread included).
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.tree import tree_copy_, tree_leaves
from deeplearning4j_tpu_torch.util.compile_watcher import (_shape_of,
                                                           get_watcher,
                                                           note_trace)

#: eager runs of the body on a side stream before a capture
WARMUP_RUNS = 2

_lock = threading.Lock()
_disabled_depth = 0  # open disabled() extents, process-wide


@contextlib.contextmanager
def disabled():
    """Run every step and forward eagerly in this extent, on every thread
    (the counterpart of ``jax.disable_jit()``): no program is built or
    replayed."""
    global _disabled_depth
    with _lock:
        _disabled_depth += 1
    try:
        yield
    finally:
        with _lock:
            _disabled_depth -= 1


def enabled() -> bool:
    """False inside :func:`disabled`."""
    return _disabled_depth == 0


def dispatch_sig(*args) -> tuple:
    """The reference's ``_dispatch_sig``: the shape/dtype signature of the
    data operands of one call, tensors, None, or dicts and lists of them."""
    return tuple(_shape_of(a) for a in args)


class CaptureError(RuntimeError):
    """A body could not be captured as a CUDA graph."""


def _leaves(tree) -> list:
    """The tensors of an argument tree in a fixed order (a dict by sorted
    key, as the signature sorts it); None holds none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _static(tree):
    """Contiguous copies of an argument tree's tensors, in its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _static(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_static(v) for v in tree)
    return tree.detach().clone(memory_format=torch.contiguous_format)


def _where(err: BaseException) -> str:
    """The innermost frame outside torch that raised ``err``: file, line
    and source, the operation that broke the capture."""
    frames = traceback.extract_tb(err.__traceback__)
    torch_dir = os.path.dirname(torch.__file__)
    own = [f for f in frames if not f.filename.startswith(torch_dir)]
    f = (own or frames or [None])[-1]
    if f is None:
        return "no Python frame (the capture was invalidated)"
    return f"{f.filename}:{f.lineno}: {f.line}"


class Program:
    """One step or forward at one signature (see the module doc).

    ``body(*inputs)`` computes on the static buffers ``inputs`` (built from
    ``example``, a tuple of argument trees); ``state``: every tensor the
    body updates in place besides its inputs; ``generators``: the dropout
    generators it draws from; ``trace_args``: what the watcher attributes
    the build to (the reference's ``note_trace`` arguments)."""

    def __init__(self, fn_name: str, body: Callable, example: tuple, *,
                 device: torch.device, pool=None,
                 state: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = (),
                 trace_args: Optional[tuple] = None):
        trace_args = example if trace_args is None else trace_args
        note_trace(fn_name, *trace_args)
        self.fn_name = fn_name
        self.sig = dispatch_sig(*trace_args)
        self._body = body
        self.inputs = _static(tuple(example))
        self._flat = _leaves(self.inputs)
        self.outputs: Any = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: bytes the network's graph pool grew by at this capture
        self.pool_bytes = 0
        #: launch counts of one replay (LAUNCHES, PLAIN_ON_CUDA, bodies)
        self.counts: tuple = ({}, {}, {})
        self.replays = 0
        if torch.device(device).type == "cuda":
            self._capture(torch.device(device), pool, state, generators)

    def __call__(self, *args):
        for buf, src in zip(self._flat, _leaves(args)):
            if buf.data_ptr() != src.data_ptr():
                buf.copy_(src)
        if self.graph is None:
            return self._body(*self.inputs)
        self.graph.replay()
        _kern.add_counts(self.counts)
        self.replays += 1
        return self.outputs

    def _capture(self, device, pool, state, generators) -> None:
        t0 = time.perf_counter()
        kept = list(state) + self._flat
        saved = [t.clone() for t in kept]
        before = _kern.snapshot_counts()
        gen_states = [g.get_state() for g in generators]
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._body(*self.inputs)
            for t, s in zip(kept, saved):
                t.copy_(s)
        cur.wait_stream(side)
        torch.cuda.synchronize(device)
        del saved
        for g, st in zip(generators, gen_states):
            g.set_state(st)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        # a failed capture leaves its generators' states capturing
        backups = [(g, g.clone_state()) for g in (
            *generators, torch.cuda.default_generators[device.index or 0])]
        warmed = _kern.snapshot_counts()
        # dead networks in reference cycles (net -> program -> body -> net)
        # are freed here, and the collector stays off while capturing: a
        # collection inside the capture would destroy their graphs and
        # free their pinned step-size buffers in the middle of it, which
        # invalidates the capture (CUDA error 901 at the next launch)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        err, outputs = None, None
        collecting = gc.isenabled()
        gc.disable()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outputs = self._body(*self.inputs)
            except Exception as e:  # noqa: BLE001  (re-raised below)
                err = e
            finally:
                try:
                    graph.capture_end()
                except RuntimeError as e:
                    err = err or e
                if collecting:
                    gc.enable()
        self.counts = _kern.counts_since(warmed)
        _kern.restore_counts(before)
        if err is not None:
            for g, b in backups:
                g.graphsafe_set_state(b)
            raise CaptureError(
                f"capturing {self.fn_name} for signature {self.sig} failed "
                f"at {_where(err)}: {type(err).__name__}: "
                f"{str(err).splitlines()[0] if str(err) else ''}") from err
        cur.wait_stream(side)
        self.outputs, self.graph = outputs, graph
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        get_watcher().note_capture(time.perf_counter() - t0)


class CompiledSteps:
    """The program tables of a network (``MultiLayerNetwork``,
    ``ComputationGraph``), and the in-place update its steps share: the
    reference's ``_aot_steps`` (train), a TBPTT table and ``_aot_forward``,
    keyed by signature, one graph pool, and the step-size buffer the
    updaters read. The network provides ``device``, ``params``,
    ``states``, ``opt_states`` (lists by layer or dicts by node),
    ``_update_groups``, ``iteration``, ``_gen`` and ``_cast_cache``."""

    def _drop_programs(self) -> None:
        """Forget every program and the step-size buffer they read: the
        params, states or optimizer states were rebound, and a program
        would go on reading the tensors it was captured on."""
        self._aot_steps: Dict[tuple, Program] = {}
        self._tbptt_steps: Dict[tuple, Program] = {}
        self._aot_forward: Dict[tuple, Program] = {}
        self._pool = None
        self._sizes: Optional[upd.StepSizes] = None

    def _step_sizes(self) -> upd.StepSizes:
        """The step-size buffer, written for the iteration about to run."""
        if self._sizes is None:
            self._sizes = upd.StepSizes(self._update_groups, self.device)
        self._sizes.write(self.iteration)
        return self._sizes

    def _update(self, grads, new_states) -> None:
        """The updaters in place, at the step sizes in the buffer, and the
        new layer states copied into the network's own tensors."""
        upd.step_groups(self._update_groups, self.params, grads,
                        self.opt_states, self._sizes.views)
        tree_copy_(self.states, new_states)

    def _program(self, table, key, fn_name, body, args, trace_args=None,
                 train=True) -> Program:
        """``table[key]``, built from ``args`` when missing; a train
        program restores and registers what its steps update."""
        prog = table.get(key)
        if prog is None:
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            prog = table[key] = Program(
                fn_name, body, args, device=self.device, pool=self._pool,
                state=tree_leaves([self.params, self.states,
                                   self.opt_states]) if train else (),
                generators=(self._gen,) if train else (),
                trace_args=trace_args)
        return prog

    def _replay_step(self, table, fn_name, body, args, trace_args=None):
        """A train program's step on ``args`` (built on first sight of
        their signature); returns a copy of its loss, which the next replay
        overwrites, and the program. The replay updates the params inside
        the graph, where their version counters do not move, so the eager
        cast cache is emptied."""
        prog = self._program(table, dispatch_sig(*args), fn_name, body,
                             args, trace_args)
        loss = prog(*args).clone()
        self._cast_cache.clear()
        return loss, prog

    def programs(self) -> Dict[str, Program]:
        """Every program built so far, by function name and signature."""
        return {f"{p.fn_name} {sig}": p
                for t in (self._aot_steps, self._tbptt_steps,
                          self._aot_forward)
                for sig, p in t.items()}
