"""Transfer learning on MultiLayerNetwork: freeze, replace, fine-tune
(counterpart of deeplearning4j_tpu/nn/transfer.py; TransferLearning.java,
FineTuneConfiguration.java and FrozenLayer.java in DL4J).

    new_net = (TransferLearning.Builder(base_net)
               .fine_tune_configuration(FineTuneConfiguration(
                   updater={"@updater": "Adam", "learning_rate": 1e-4}))
               .set_feature_extractor(3)          # freeze layers 0..3
               .n_out_replace(5, 10)              # new class count on layer 5
               .remove_output_layer()
               .add_layer(OutputLayer(...))
               .build())

:class:`FrozenLayer` runs its inner layer in inference mode on detached
params, so no gradient reaches them: the network hands its updater zero
gradients for them, which leave Adam's update exactly zero (the reference's
``stop_gradient``). The built network is initialized on the source
network's device from the conf's seed; every layer whose params and states
keep their shapes gets the source's, copied.

Not ported yet: ``_TransferGraphBuilder`` (surgery on a ComputationGraph)
and ``TransferLearningHelper`` (featurizing through the frozen prefix); see
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import _updater_dict
from deeplearning4j_tpu_torch.nn.layers import Layer, register_layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.tree import tree_map


@register_layer
@dataclasses.dataclass(frozen=True)
class FrozenLayer(Layer):
    """Wraps a layer and blocks its gradients (reference ``:47``): the inner
    layer runs in inference mode (batchnorm's running statistics, no
    dropout) on detached params, passes the mask through where the inner
    layer takes one, and adds no l1/l2 penalty."""

    inner: Optional[Layer] = None

    def initialize(self, gen, input_shape):
        return self.inner.initialize(gen, input_shape)

    def apply(self, params, state, x, *, training=False, gen=None, mask=None):
        frozen = tree_map(lambda v: v.detach(), params)
        kw = {}
        if "mask" in inspect.signature(self.inner.apply).parameters:
            kw["mask"] = mask
        y, _ = self.inner.apply(frozen, state, x, training=False, **kw)
        return y, state

    def output_shape(self, input_shape):
        return self.inner.output_shape(input_shape)

    def regularization(self, params):
        return 0.0

    def to_dict(self):
        d = super().to_dict()
        d["inner"] = self.inner.to_dict()
        return d


@dataclasses.dataclass
class FineTuneConfiguration:
    """Overrides for the built network (reference ``:88``): its updater (a
    reference updater dict or an updater object), seed, and the input
    dropout of every layer that is not frozen."""

    updater: Any = None
    seed: Optional[int] = None
    dropout: Optional[float] = None


def _shapes(tree: dict):
    return tree_map(lambda v: tuple(v.shape), tree)


class TransferLearning:
    class Builder:
        """TransferLearning.Builder for a MultiLayerNetwork (reference
        ``:97-205``)."""

        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._nout_replace: dict = {}
            self._remove_from: Optional[int] = None
            self._added: List[Layer] = []

        def fine_tune_configuration(self, cfg: FineTuneConfiguration):
            self._fine_tune = cfg
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers 0..layer_idx inclusive."""
            self._freeze_until = layer_idx
            return self

        def n_out_replace(self, layer_idx: int, n_out: int,
                          weight_init: str = "xavier"):
            """Re-initialize layer ``layer_idx`` at a new output width, and
            the next layer that has an ``n_in`` at the matching input width
            (nOutReplace); the width-keeping layers between are
            re-initialized too."""
            self._nout_replace[layer_idx] = (n_out, weight_init)
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            self._remove_from = n
            return self

        def add_layer(self, layer: Layer):
            self._added.append(layer)
            return self

        def build(self) -> MultiLayerNetwork:
            src = self._net
            layers = list(src.conf.layers)
            params = [tree_map(torch.clone, p) for p in src.params]
            states = [tree_map(torch.clone, s) for s in src.states]
            if self._remove_from:
                layers = layers[:-self._remove_from]
                params = params[:-self._remove_from]
                states = states[:-self._remove_from]

            reinit: set = set()
            for idx, (n_out, wi) in self._nout_replace.items():
                layers[idx] = dataclasses.replace(layers[idx], n_out=n_out,
                                                  weight_init=wi)
                reinit.add(idx)
                j = idx + 1
                while j < len(layers) and not hasattr(layers[j], "n_in"):
                    reinit.add(j)
                    j += 1
                if j < len(layers):
                    layers[j] = dataclasses.replace(layers[j], n_in=n_out)
                    reinit.add(j)

            layers.extend(self._added)
            if self._freeze_until is not None:
                for i in range(self._freeze_until + 1):
                    if not isinstance(layers[i], FrozenLayer):
                        layers[i] = FrozenLayer(inner=layers[i])

            ft = self._fine_tune or FineTuneConfiguration()
            if ft.dropout is not None:
                start = (self._freeze_until + 1
                         if self._freeze_until is not None else 0)
                for i in range(start, len(layers)):
                    if not isinstance(layers[i], FrozenLayer):
                        layers[i] = dataclasses.replace(layers[i],
                                                        dropout=ft.dropout)
            conf = dataclasses.replace(
                src.conf, layers=layers,
                updater=_updater_dict(ft.updater) or src.conf.updater,
                seed=ft.seed if ft.seed is not None else src.conf.seed,
                knobs=dict(src.conf.knobs))
            new_net = MultiLayerNetwork(conf).init(device=src.device)
            # graft where the shapes held: a width change can ripple into
            # layers without an n_in (batchnorm), so compare the trees
            for i in range(min(len(params), len(layers))):
                if (i not in reinit
                        and _shapes(params[i]) == _shapes(new_net.params[i])
                        and _shapes(states[i]) == _shapes(new_net.states[i])):
                    new_net.params[i] = params[i]
                    new_net.states[i] = states[i]
            if new_net._fused is not None:
                # the fused masters were built from the new net's random
                # params: resync them to the grafted ones
                new_net._fused.resync_masters(new_net.params,
                                              new_net.opt_states)
            new_net._drop_programs()  # they would read the replaced trees
            return new_net
