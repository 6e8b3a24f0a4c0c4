"""Network configuration builder (counterpart of
deeplearning4j_tpu/nn/conf.py): ``InputType``, the
``NeuralNetConfiguration.builder()`` chain a ComputationGraph
(``graph_builder()``) or a MultiLayerNetwork (``list()`` ->
:class:`ListBuilder` -> :class:`MultiLayerConfiguration`) is built with,
and the JSON helpers both packages share the format of.

The builder carries what ResNet-50, BERT and the char-RNN set: seed,
updater, compute dtype, kernel dispatch, the TBPTT segment length, the
remat knobs and the batch and time buckets (whose default a
``DL4J_TPU_BUCKETS`` spec sets, as in the reference); the reference's
other global settings (l1/l2, weight_init and activation stamping onto the
layers) come with the slices that use them.
``compute_dtype="bfloat16"`` keeps params fp32 and runs activations and
convolutions in bf16.

JSON: the port reads the JSON the JAX package writes and writes JSON the
JAX package reads. The knobs of :data:`INERT_KNOBS` are kept as read and
written back, with the reference's defaults; of them the port acts on
``tbptt_length`` (``MultiLayerNetwork.fit``) and ``sync_every`` (the
listener dispatch window of both networks' ``fit``) and leaves the rest
(remat policy, loss scaling, gradient compression, pipelining, ...) for
later slices. The
updater is kept as the reference's updater dict. ``kernel_impl`` is the one
key whose vocabulary differs: the reference's forced-kernel mode
``"pallas"`` is the port's ``"cuda"``, translated both ways.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.ops import kernels as _kern

#: conf keys kept verbatim, with the reference's defaults
#: (deeplearning4j_tpu/nn/computation_graph.py:59-100), in its JSON order
INERT_KNOBS = {
    "tbptt_length": 0,
    "remat_policy": None,
    "stage_barriers": False,
    "sync_every": 1,
    "fused_update": False,
    "loss_scale": "none",
    "loss_scale_value": 2.0 ** 15,
    "loss_scale_growth": 2000,
    "grad_compression": "none",
    "grad_compression_threshold": 1e-3,
    "grad_compression_target": 1e-3,
    "pipe_stages": 0,
    "n_micro": 0,
}

#: the reference builder's default updater, Sgd(0.1), as its JSON dict
DEFAULT_UPDATER = {"learning_rate": 0.1, "@updater": "Sgd"}


class InputType:
    """org/deeplearning4j/nn/conf/inputs/InputType.java parity (NHWC)."""

    @staticmethod
    def feed_forward(size: int) -> Tuple[int, ...]:
        return (size,)

    @staticmethod
    def convolutional(height: int, width: int,
                      channels: int) -> Tuple[int, ...]:
        return (height, width, channels)

    @staticmethod
    def recurrent(size: int,
                  timesteps: Optional[int] = None) -> Tuple[Optional[int], ...]:
        """(T, F) sequences; T is None when the length is not fixed."""
        return (timesteps, size) if timesteps else (None, size)


def _buckets_to_json(spec):
    """Bucket spec -> JSON value: None | "pow2" | [sizes]."""
    if spec is None or spec == "pow2":
        return spec
    return list(spec)


def _buckets_from_json(v):
    if v is None or v == "pow2":
        return v
    return tuple(v)


def _detuple(v):
    """JSON lists -> tuples (layer configs use tuples for shapes)."""
    return tuple(_detuple(x) if isinstance(x, list) else x for x in v)


def kernel_impl_from_json(v: Optional[str]) -> Optional[str]:
    return "cuda" if v == "pallas" else _kern.validate_impl(v)


def kernel_impl_to_json(v: Optional[str]) -> Optional[str]:
    return "pallas" if v == "cuda" else v


def _updater_dict(u):
    """The reference's updater dict from a dict or an object that has
    ``to_dict()``; None stays None."""
    if u is None or isinstance(u, dict):
        return u
    return u.to_dict()


class NeuralNetConfiguration:
    """Fluent builder entry point (NeuralNetConfiguration.Builder parity)."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._seed = 12345
        self._updater = dict(DEFAULT_UPDATER)
        self._compute_dtype = "float32"
        self._kernel_impl: Optional[str] = None
        self._knobs = dict(INERT_KNOBS)
        self._batch_buckets = None
        self._seq_buckets = None
        # DL4J_TPU_BUCKETS folds into the default buckets, as the
        # reference's builder does (``nn/conf.py:270-280``)
        from deeplearning4j_tpu_torch.config import get_environment

        spec = get_environment().default_buckets
        if spec:
            from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy

            try:  # fail fast: a typo'd env spec must not survive to fit()
                pol = BucketingPolicy.from_spec(spec)
            except ValueError as e:
                raise ValueError(f"DL4J_TPU_BUCKETS: {e}") from None
            if pol is not None:
                self._batch_buckets = pol.batch_buckets
                self._seq_buckets = pol.seq_buckets

    def seed(self, s: int) -> "Builder":
        self._seed = int(s)
        return self

    def updater(self, u) -> "Builder":
        """Kept as config for the training slice: the reference's updater
        dict (e.g. ``{"@updater": "Adam", "learning_rate": 1e-3, ...}``)
        or any object with ``to_dict()``."""
        self._updater = _updater_dict(u)
        return self

    def compute_dtype(self, dt: str) -> "Builder":
        if dt not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32|bfloat16, "
                             f"got {dt!r}")
        self._compute_dtype = dt
        return self

    def kernel_impl(self, impl: Optional[str]) -> "Builder":
        """Pin the kernel dispatch for this net: ``"auto"``, ``"exact"``
        (plain PyTorch) or ``"cuda"`` (force the kernels). ``None`` defers
        to the DL4J_TORCH_KERNEL_IMPL env knob."""
        self._kernel_impl = _kern.validate_impl(impl)
        return self

    def batch_buckets(self, spec) -> "Builder":
        """Shape bucketing for the batch axis (reference ``nn/conf.py:350``):
        ``"pow2"`` or an explicit size list; ragged batches pad up to the
        nearest bucket with zero rows of loss weight 0. ``None`` turns it
        off."""
        from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy

        if spec is not None:  # fail fast on malformed specs
            BucketingPolicy(batch_buckets=spec)
        self._batch_buckets = spec
        return self

    def seq_buckets(self, spec) -> "Builder":
        """Shape bucketing for the time axis (reference ``:364``):
        ``"pow2"``, an explicit size list, or ``None`` (off)."""
        from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy

        if spec is not None:
            BucketingPolicy(seq_buckets=spec)
        self._seq_buckets = spec
        return self

    def tbptt_length(self, k: int) -> "Builder":
        """Truncated BPTT (reference ``nn/conf.py:310``): ``fit`` splits the
        time axis into length-k segments, the recurrent state carried
        forward and the gradients stopped at segment boundaries."""
        self._knobs["tbptt_length"] = int(k)
        return self

    def sync_every(self, n: int) -> "Builder":
        """Dispatch the listeners every ``n`` iterations (reference
        ``nn/conf.py:337``): each window's losses come to the host in one
        copy, and every listener still sees every iteration, up to n - 1
        iterations late. 1 (the default) calls them after each step."""
        if n < 1:
            raise ValueError(f"sync_every must be >= 1, got {n}")
        self._knobs["sync_every"] = int(n)
        return self

    def remat_policy(self, name: Optional[str]) -> "Builder":
        """Kept as config (the training slice acts on it)."""
        self._knobs["remat_policy"] = name
        return self

    def stage_barriers(self, on: bool = True) -> "Builder":
        """Kept as config (the training slice acts on it)."""
        self._knobs["stage_barriers"] = bool(on)
        return self

    def list(self) -> "ListBuilder":
        """Layer-stack builder (NeuralNetConfiguration.ListBuilder parity)."""
        return ListBuilder(self)

    def graph_builder(self):
        """DAG builder (ComputationGraphConfiguration.GraphBuilder parity)."""
        from deeplearning4j_tpu_torch.nn.computation_graph import GraphBuilder

        return GraphBuilder(self)


@dataclasses.dataclass
class MultiLayerConfiguration:
    """A layer stack (MultiLayerConfiguration.java parity; reference
    ``nn/conf.py:45``). ``input_shape`` excludes the batch; ``remat_stages``
    are layer indices that start a stage; ``knobs`` holds the
    :data:`INERT_KNOBS` kept for later slices."""

    layers: List[L.Layer]
    seed: int = 12345
    updater: Optional[dict] = None
    input_shape: Optional[Tuple[Optional[int], ...]] = None
    compute_dtype: str = "float32"
    kernel_impl: Optional[str] = None  # auto | exact | cuda | None (ambient)
    batch_buckets: Any = None
    seq_buckets: Any = None
    remat_stages: Optional[Tuple[int, ...]] = None
    knobs: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(INERT_KNOBS))

    @property
    def tbptt_length(self) -> int:
        """The TBPTT segment length; 0 = whole-sequence BPTT."""
        return int(self.knobs.get("tbptt_length") or 0)

    @tbptt_length.setter
    def tbptt_length(self, k: int) -> None:
        self.knobs["tbptt_length"] = int(k)

    def to_json(self) -> str:
        """The reference's JSON (``nn/conf.py:102``), key for key."""
        k = {**INERT_KNOBS, **self.knobs}
        return json.dumps({
            "seed": self.seed,
            "updater": self.updater,
            "input_shape": list(self.input_shape)
            if self.input_shape else None,
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
            "layers": [lyr.to_dict() for lyr in self.layers],
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        """Read the reference's JSON (``nn/conf.py:133``)."""
        d = json.loads(s)

        def fix(lyr):
            # a wrapper (FrozenLayer) holds its inner layer's dict
            return L.layer_from_dict({
                k: fix(v) if isinstance(v, dict) and "@layer" in v
                else _detuple(v) if isinstance(v, list) else v
                for k, v in lyr.items()})

        return MultiLayerConfiguration(
            layers=[fix(x) for x in d["layers"]],
            seed=d["seed"],
            updater=d.get("updater"),
            input_shape=tuple(d["input_shape"])
            if d.get("input_shape") else None,
            compute_dtype=d.get("compute_dtype", "float32"),
            kernel_impl=kernel_impl_from_json(d.get("kernel_impl")),
            batch_buckets=_buckets_from_json(d.get("batch_buckets")),
            seq_buckets=_buckets_from_json(d.get("seq_buckets")),
            remat_stages=tuple(d["remat_stages"])
            if d.get("remat_stages") else None,
            knobs={k: d.get(k, v) for k, v in INERT_KNOBS.items()},
        )


class ListBuilder:
    """NeuralNetConfiguration.ListBuilder parity (reference
    ``nn/conf.py:456``)."""

    def __init__(self, parent: Builder):
        self._p = parent
        self._layers: List[L.Layer] = []
        self._input_shape = None

    def layer(self, lyr: L.Layer) -> "ListBuilder":
        self._layers.append(lyr)
        return self

    def set_input_type(self, shape) -> "ListBuilder":
        self._input_shape = tuple(shape)
        return self

    def build(self) -> MultiLayerConfiguration:
        p = self._p
        return MultiLayerConfiguration(
            layers=list(self._layers),
            seed=p._seed,
            updater=p._updater,
            input_shape=self._input_shape,
            compute_dtype=p._compute_dtype,
            kernel_impl=p._kernel_impl,
            batch_buckets=p._batch_buckets,
            seq_buckets=p._seq_buckets,
            knobs=dict(p._knobs),
        )
