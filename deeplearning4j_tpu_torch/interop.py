"""Weights and training state carried across from the JAX package, and back
(no counterpart there).

The reference's ``ComputationGraph.params``/``states`` are nested dicts
node-name -> {key: array}, keyed ``W``/``b``/``gamma``/``beta``/``mean``/
``var`` in the reference's layouts (HWIO conv weights, (n_in, n_out) dense
weights). Its ``opt_states`` are node-name -> the updater's state tree
(``()`` for Sgd/NoOp, ``{"m": {key: array}, "v": {...}}`` for Adam, ...),
the same trees the port's updaters keep. Turned into numpy on the caller's
side (``jax.tree_util.tree_map(np.asarray, net.opt_states)``), they copy
into the port's graph as they are: the layouts are the same, so nothing is
transposed. The loaders bind new tensors, so they drop the network's
captured programs (``nn/capture.py``), which read the old ones. :func:`to_numpy` hands the port's trees back in that form, so
a trajectory compares leaf by leaf and can continue in either package.

A ``MultiLayerNetwork``'s params, states and optimizer states are lists
with one entry per layer (``{}`` for a layer without params), keyed as the
reference keys them (``W``/``U``/``b`` for an LSTM, with ``peep`` for a
GravesLSTM; ``nn/transformer.py:57-63`` and ``:140-149`` for BERT); they
copy across with :func:`load_reference_mln`, with the iteration and epoch,
so a test can start both packages from the same point. A wrapper's params
are nested in both packages (Bidirectional's and GravesBidirectionalLSTM's
``{"fwd": {...}, "bwd": {...}}``) and copy leaf by leaf. The conv zoo's
trees copy the same way: SeparableConvolution2D's ``depthW`` (kh, kw, Cin,
multiplier), ``pointW`` (1, 1, Cin * multiplier, Cout) and ``b``,
Deconvolution2D's ``W`` (kh, kw, Cin, Cout), EmbeddingLayer's ``W``
(vocabulary, dimension), LayerNormalization's ``gamma``/``beta``; a
SharedLayer node's tree is empty in both (its source holds the params).
So do ``nn/layers_spatial.py``'s: DepthwiseConvolution2D's ``W`` (kh, kw,
C, multiplier) and ``b``, Convolution1D's ``W`` (k, Cin, Cout),
Convolution3D's ``W`` (kd, kh, kw, Cin, Cout), the locally connected
layers' ``W`` (positions, window * Cin, Cout) and ``b`` (positions,
Cout), PReLULayer's ``alpha``, ElementWiseMultiplicationLayer's ``w`` and
``b``; MaskZeroLayer and TimeDistributed hold their layer's tree as it
is. A network the Keras importer built (either package's) crosses the
same way.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.computation_graph import (
    ComputationGraph, ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.tree import tree_items, tree_map, tree_set


def _copy_tree(name: str, dst: Dict[str, dict], src: Dict[str, dict],
               device) -> None:
    if set(src) != set(dst):
        raise ValueError(
            f"{name}: node sets differ; missing "
            f"{sorted(set(dst) - set(src))}, unexpected "
            f"{sorted(set(src) - set(dst))}")
    for node, tree in src.items():
        have = dict(tree_items(dst[node]))
        leaves = tree_items(tree)
        if {p for p, _ in leaves} != set(have):
            raise ValueError(f"{name}[{node!r}]: leaves "
                             f"{sorted(p for p, _ in leaves)} != "
                             f"{sorted(have)}")
        for path, arr in leaves:
            a = np.asarray(arr)
            want = tuple(have[path].shape)
            if a.shape != want:
                raise ValueError(f"{name}[{node!r}]{list(path)}: shape "
                                 f"{a.shape} != {want}")
            tree_set(dst[node], path, torch.from_numpy(
                np.array(a, np.float32, copy=True)).to(device))


def _copy_opt_tree(path: str, dst, src, device):
    """The reference's state tree for one node -> tensors, shaped as the
    port's own tree ``dst`` (dicts recurse, ``()`` stays empty)."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"{path}: keys "
                             f"{sorted(src) if isinstance(src, dict) else src}"
                             f" != {sorted(dst)}")
        return {k: _copy_opt_tree(f"{path}[{k!r}]", dst[k], src[k], device)
                for k in dst}
    if isinstance(dst, (tuple, list)):
        if len(src) != len(dst):
            raise ValueError(f"{path}: {len(src)} entries != {len(dst)}")
        return type(dst)(_copy_opt_tree(f"{path}[{i}]", d, s, device)
                         for i, (d, s) in enumerate(zip(dst, src)))
    a = np.asarray(src)
    if a.shape != tuple(dst.shape):
        raise ValueError(f"{path}: shape {a.shape} != {tuple(dst.shape)}")
    return torch.from_numpy(np.array(a, np.float32, copy=True)).to(device)


def load_reference(net: ComputationGraph, params: dict, states: dict,
                   opt_states: dict = None, iteration: int = None,
                   epoch: int = None) -> ComputationGraph:
    """Copy the reference's params/states (nested dicts of numpy arrays)
    into an initialized port graph, in place; with ``opt_states`` (the
    reference's ``opt_states`` as numpy), ``iteration`` and ``epoch`` also
    its optimizer state and counters, so training continues where the
    reference's left off."""
    if net.device is None:
        raise ValueError("init() the port graph before load_reference()")
    _copy_tree("params", net.params, params, net.device)
    _copy_tree("states", net.states, states, net.device)
    _resync_fused(net, opt_states)
    if opt_states is not None:
        if set(opt_states) != set(net.opt_states):
            raise ValueError(
                f"opt_states: node sets differ: {sorted(opt_states)} != "
                f"{sorted(net.opt_states)}")
        net.opt_states = {
            name: _copy_opt_tree(f"opt_states[{name!r}]", tree,
                                 opt_states[name], net.device)
            for name, tree in net.opt_states.items()}
    if iteration is not None:
        net.iteration = int(iteration)
    if epoch is not None:
        net.epoch = int(epoch)
    net._cast_cache = {}
    net._drop_programs()
    return net


def load_reference_mln(net: MultiLayerNetwork, params, states,
                       opt_states=None, iteration: int = None,
                       epoch: int = None) -> MultiLayerNetwork:
    """Copy the reference MultiLayerNetwork's params/states (lists of
    per-layer dicts of numpy arrays) into an initialized port network, in
    place; with ``opt_states`` (the reference's per-layer optimizer states
    as numpy), ``iteration`` and ``epoch`` also its training state."""
    if net.device is None:
        raise ValueError("init() the port network before load_reference_mln()")
    for name, dst, src in (("params", net.params, params),
                           ("states", net.states, states)):
        if len(src) != len(dst):
            raise ValueError(f"{name}: {len(src)} layers != {len(dst)}")
        # the per-layer dicts are updated in place
        _copy_tree(name, {str(i): d for i, d in enumerate(dst)},
                   {str(i): d for i, d in enumerate(src)}, net.device)
    _resync_fused(net, opt_states)
    if opt_states is not None:
        if len(opt_states) != len(net.opt_states):
            raise ValueError(f"opt_states: {len(opt_states)} layers != "
                             f"{len(net.opt_states)}")
        net.opt_states = [
            _copy_opt_tree(f"opt_states[{i}]", tree, src, net.device)
            for i, (tree, src) in enumerate(zip(net.opt_states, opt_states))]
    if iteration is not None:
        net.iteration = int(iteration)
    if epoch is not None:
        net.epoch = int(epoch)
    net._cast_cache = {}
    net._drop_programs()
    return net


def _resync_fused(net, opt_states) -> None:
    """A fused net's masters follow the params just copied in; its flat
    buffers are laid out in the port's leaf order, so the reference's
    fused optimizer state does not copy across."""
    if getattr(net, "_fused", None) is None:
        return
    if opt_states is not None:
        raise ValueError("opt_states of a fused_update net do not copy "
                         "between the packages (their flat buffers order "
                         "the leaves differently); load the params only")
    net._fused.resync_masters(net.params, net.opt_states)


def _numpy_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def to_numpy(net) -> dict:
    """The port network's state as numpy, in the reference's tree shapes:
    ``{"params", "states", "opt_states", "iteration", "epoch"}`` for a
    graph, ``{"params", "states"}`` (lists of per-layer dicts) for a
    MultiLayerNetwork."""
    if isinstance(net, MultiLayerNetwork):
        return {"params": _numpy_tree(net.params),
                "states": _numpy_tree(net.states)}
    return {"params": _numpy_tree(net.params),
            "states": _numpy_tree(net.states),
            "opt_states": _numpy_tree(net.opt_states),
            "iteration": net.iteration, "epoch": net.epoch}


def from_reference_json(conf_json: str, params, states, device=None):
    """A port network from the reference's conf JSON and its params/states,
    on ``device`` (CUDA unless named otherwise): a ComputationGraph for a
    graph conf, a MultiLayerNetwork for a layer-stack conf (one with
    ``layers``)."""
    if "layers" in json.loads(conf_json):
        conf = MultiLayerConfiguration.from_json(conf_json)
        return load_reference_mln(MultiLayerNetwork(conf).init(device=device),
                                  params, states)
    conf = ComputationGraphConfiguration.from_json(conf_json)
    return load_reference(ComputationGraph(conf).init(device=device), params,
                          states)
