"""Weights carried across from the JAX package (no counterpart there).

The reference's ``ComputationGraph.params``/``states`` are nested dicts
node-name -> {key: array}, keyed ``W``/``b``/``gamma``/``beta``/``mean``/
``var`` in the reference's layouts (HWIO conv weights, (n_in, n_out) dense
weights). Turned into numpy on the caller's side
(``jax.tree_util.tree_map(np.asarray, net.params)``), they copy into the
port's graph as they are: the layouts are the same, so nothing is
transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.computation_graph import (
    ComputationGraph, ComputationGraphConfiguration)


def _copy_tree(name: str, dst: Dict[str, dict], src: Dict[str, dict],
               device) -> None:
    if set(src) != set(dst):
        raise ValueError(
            f"{name}: node sets differ; missing "
            f"{sorted(set(dst) - set(src))}, unexpected "
            f"{sorted(set(src) - set(dst))}")
    for node, leaves in src.items():
        if set(leaves) != set(dst[node]):
            raise ValueError(f"{name}[{node!r}]: keys {sorted(leaves)} != "
                             f"{sorted(dst[node])}")
        for key, arr in leaves.items():
            a = np.asarray(arr)
            want = tuple(dst[node][key].shape)
            if a.shape != want:
                raise ValueError(f"{name}[{node!r}][{key!r}]: shape "
                                 f"{a.shape} != {want}")
            dst[node][key] = torch.from_numpy(
                np.array(a, np.float32, copy=True)).to(device)


def load_reference(net: ComputationGraph, params: dict,
                   states: dict) -> ComputationGraph:
    """Copy the reference's initialized params/states (nested dicts of
    numpy arrays) into an initialized port graph, in place."""
    if net.device is None:
        raise ValueError("init() the port graph before load_reference()")
    _copy_tree("params", net.params, params, net.device)
    _copy_tree("states", net.states, states, net.device)
    return net


def from_reference_json(conf_json: str, params: dict, states: dict,
                        device=None) -> ComputationGraph:
    """A port graph from the reference's conf JSON and its params/states,
    on ``device`` (CUDA unless named otherwise)."""
    conf = ComputationGraphConfiguration.from_json(conf_json)
    return load_reference(ComputationGraph(conf).init(device=device), params,
                          states)
