"""Search-space registry: the seams' tunable knobs as typed candidate sets
(counterpart of deeplearning4j_tpu/tuning/space.py).

Each :class:`SearchSpace` names one seam, emits its candidates for a
concrete workload context, guards each with the seam's validity checks,
and builds the measurable case (reference outputs, candidate outputs, a
timed runner) that ``tuning/measure.py`` sweeps.

Registered spaces:

- ``conv2d_tiles``: MEASURABLE. The conv kernel's forward whole and at each
  ``row_tile`` that divides the output height (K2), and the plain version
  as candidate ``exact``. The candidates differ in the forward only (the
  input and filter gradients take their kernels whatever the forward
  took), so the case gates and times the forward.
- ``lstm_tiles``: MEASURABLE. The TPU kernel's batch tile has no
  counterpart (the CUDA segment kernel's tile is fixed by its launch
  geometry), so the candidates are ``exact`` (the layer's plain per-step
  loop) and the kernel whole (``cuda:bt=whole``). The choice decides the
  forward and the backward (the kernel's adjoint Function against the
  loop's autograd), so the case gates and times value and gradients. The
  name and database keys are the reference's.
- ``bucket_sets``, ``affinity_head``, ``compression_hosts``,
  ``pipe_schedule``: DECLARED (ranking needs a recorded length
  distribution, a live fleet under shared-prefix traffic, real hosts on a
  real interconnect, stages placed on devices of their own).
- ``prefill_chunk``: MEASURABLE (conf scope), gated on generated-token
  identity.
- ``remat_policy``: MEASURABLE (conf scope): every policy registered in
  ``util/xla_tuning.py`` on a small conv net's train step, gated on its
  3-step loss (remat recomputes; it must not change the arithmetic); the
  winner lands under ``conf-default``, which the conf builders read.
- ``xla_flags``: DECLARED: the reference's XLA flag candidates
  (``xla_tuning.XLA_FLAG_CANDIDATES``), each reported invalid here: there
  is no XLA on this build, as the reference reports TPU flags rejected on
  the CPU.

Kernel candidates call the kernels' wrappers, which launch on CUDA tensors
and run their plain versions on CPU tensors: on the CPU a sweep proves the
machinery and the gate, not a ranking.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

from deeplearning4j_tpu_torch.tuning.database import TuningKey


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point in a search space: a dispatch choice (``impl``) plus its
    typed parameters. ``label`` is the stable human/database name."""

    label: str
    impl: str = "exact"            # "exact" | "cuda" | knob-specific
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    is_default: bool = False

    def as_dict(self) -> dict:
        return {"label": self.label, "impl": self.impl,
                "params": dict(self.params),
                "is_default": self.is_default}


class MeasureCase:
    """One concrete workload built by a space: the reference outputs, a
    per-candidate output function (for the equivalence gate), a
    per-candidate runner (one call = one execution, queued, not waited
    for) and ``sync``, which waits for the device and closes each timed
    window."""

    def __init__(self, *, reference: Callable[[], Any],
                 outputs: Callable[[Candidate], Any],
                 timer: Callable[[Candidate], Callable[[], None]],
                 tolerance: float, sync: Callable[[], None] = None):
        self.reference = reference
        self.outputs = outputs
        self.timer = timer
        self.tolerance = tolerance
        self.sync = sync or (lambda: None)


class SearchSpace:
    """Base declaration. Subclasses override the class attributes and the
    methods; ``measurable=False`` spaces only declare (enumerate + key) and
    state what measuring them ``requires``."""

    name: str = ""
    op: str = ""                   # database key op
    scope: str = "op"              # "op" (shape-keyed) | "conf"
    measurable: bool = True
    requires: str = ""             # why a declared space cannot measure here
    tolerance: float = 1e-5        # per-seam equivalence bound (abs, fp32)

    def signature(self, ctx: dict) -> str:
        raise NotImplementedError

    def dtype(self, ctx: dict) -> str:
        return str(ctx.get("dtype", "float32"))

    def key(self, ctx: dict) -> TuningKey:
        return TuningKey.for_op(self.op, self.signature(ctx),
                                self.dtype(ctx))

    def enumerate(self, ctx: dict) -> List[Candidate]:
        raise NotImplementedError

    def validate(self, cand: Candidate, ctx: dict) -> Tuple[bool, str]:
        """(ok, reason): invalid candidates are recorded as skipped, never
        measured."""
        return True, ""

    def neighbors(self, cand: Candidate, ctx: dict) -> List[Candidate]:
        """Adjacent candidates for greedy refinement (random search)."""
        return []

    def build(self, ctx: dict) -> MeasureCase:
        raise NotImplementedError(
            f"space {self.name!r} is declared, not measurable here"
            + (f" (requires {self.requires})" if self.requires else ""))

    def default_contexts(self) -> List[dict]:
        """The workload contexts a sweep takes when none is named."""
        return []


# ---------------------------------------------------------------- registry
_REGISTRY: Dict[str, SearchSpace] = {}


def register_space(space: SearchSpace) -> SearchSpace:
    """Declare a knob space (re-registering a name replaces it)."""
    if not space.name:
        raise ValueError("search space needs a name")
    _REGISTRY[space.name] = space
    return space


def get_space(name: str) -> SearchSpace:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown search space {name!r}; known: {space_names()}"
        ) from None


def space_names() -> List[str]:
    return sorted(_REGISTRY)


def measurable_spaces() -> List[str]:
    return sorted(n for n, s in _REGISTRY.items() if s.measurable)


def _device(ctx: dict):
    import torch

    dev = ctx.get("device")
    if dev is None:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(dev)


def _sync_for(device) -> Callable[[], None]:
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _torch_dtype(name: str):
    from deeplearning4j_tpu_torch.dtypes import by_name

    return by_name(name)


#: equivalence bounds by dtype (PERF.md §2's gates): the conv forward and
#: the LSTM against their plain versions, normalised by max(1, |ref|)
_BF16_TOL = 2.0 ** -7


# ----------------------------------------------------- conv2d tile space
class ConvTileSpace(SearchSpace):
    """The conv forward's row tiles (K2) and the plain version, per conv
    geometry. Context: ``{"x_shape", "w_shape", "strides", "padding",
    "dilation", "groups", "dtype"[, "device"]}`` (NHWC, HWIO).

    No VMEM guard: the reference's (``fits_vmem``) sizes a TPU program that
    holds a whole-OH accumulator block in VMEM; the CUDA kernel streams
    its tiles through shared memory at any size, so every dividing tile
    is valid (as ``ops/kernels/conv.py`` says of its gate)."""

    name = "conv2d_tiles"
    op = "conv2d"
    tolerance = 2e-4   # conv fwd bound (fp32)

    def _geom(self, ctx):
        from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

        x_shape = tuple(ctx["x_shape"])
        w_shape = tuple(ctx["w_shape"])
        strides = tuple(ctx.get("strides", (1, 1)))
        dilation = tuple(ctx.get("dilation", (1, 1)))
        groups = int(ctx.get("groups", 1))
        pads = kconv.resolve_padding(
            ctx.get("padding", "SAME"), x_shape[1:3], w_shape[:2], strides,
            dilation)
        oh = kconv._out_size(x_shape[1], pads[0], w_shape[0], strides[0],
                             dilation[0])
        return x_shape, w_shape, strides, dilation, groups, pads, oh

    def signature(self, ctx: dict) -> str:
        from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

        x_shape, w_shape, strides, dilation, groups, _, _ = self._geom(ctx)
        return kconv.shape_signature(x_shape, w_shape, strides,
                                     ctx.get("padding", "SAME"), dilation,
                                     groups)

    def enumerate(self, ctx: dict) -> List[Candidate]:
        from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

        oh = self._geom(ctx)[-1]
        out = [Candidate("exact", impl="exact", is_default=True)]
        for rt in kconv.valid_row_tiles(oh):
            label = "cuda:rt=whole" if rt is None else f"cuda:rt={rt}"
            out.append(Candidate(label, impl="cuda",
                                 params={"row_tile": rt}))
        return out

    def validate(self, cand: Candidate, ctx: dict) -> Tuple[bool, str]:
        from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

        if cand.impl == "exact":
            return True, ""
        oh = self._geom(ctx)[-1]
        rt = cand.params.get("row_tile")
        if not kconv.valid_row_tile(oh, rt):
            return False, f"row_tile {rt} does not divide OH={oh}"
        return True, ""

    def neighbors(self, cand: Candidate, ctx: dict) -> List[Candidate]:
        if cand.impl != "cuda":
            return []
        all_c = [c for c in self.enumerate(ctx) if c.impl == "cuda"]
        tiles = [c.params.get("row_tile") for c in all_c]
        try:
            i = tiles.index(cand.params.get("row_tile"))
        except ValueError:
            return []
        return [all_c[j] for j in (i - 1, i + 1) if 0 <= j < len(all_c)]

    def tolerance_for(self, ctx: dict) -> float:
        return _BF16_TOL if self.dtype(ctx) == "bfloat16" else self.tolerance

    def build(self, ctx: dict) -> MeasureCase:
        import numpy as np
        import torch

        from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

        x_shape, w_shape, strides, dilation, groups, pads, _ = \
            self._geom(ctx)
        dev = _device(ctx)
        dtype = _torch_dtype(self.dtype(ctx))
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.normal(size=x_shape), dtype=dtype,
                            device=dev).contiguous()
        w = torch.as_tensor(rng.normal(size=w_shape) * 0.1, dtype=dtype,
                            device=dev).contiguous()

        def fn_for(cand: Candidate):
            if cand.impl == "exact":
                return lambda: kconv.conv2d_fwd_reference(
                    x, w, strides, pads, dilation, groups)
            rt = cand.params.get("row_tile")
            return lambda: kconv.conv2d_fwd(x, w, strides, pads, dilation,
                                            groups, row_tile=rt)

        def outputs(cand: Candidate):
            with torch.no_grad():
                return (fn_for(cand)(),)

        def timer(cand: Candidate):
            f = fn_for(cand)

            def run_once():
                with torch.no_grad():
                    f()

            return run_once

        return MeasureCase(
            reference=lambda: outputs(Candidate("exact", impl="exact")),
            outputs=outputs, timer=timer, tolerance=self.tolerance_for(ctx),
            sync=_sync_for(dev))

    def default_contexts(self) -> List[dict]:
        import torch

        if not torch.cuda.is_available():
            return [
                {"x_shape": (2, 16, 16, 8), "w_shape": (3, 3, 8, 16),
                 "strides": (1, 1), "padding": "SAME",
                 "dilation": (1, 1), "groups": 1, "dtype": "float32"},
                {"x_shape": (2, 16, 16, 8), "w_shape": (3, 3, 8, 16),
                 "strides": (2, 2), "padding": "SAME",
                 "dilation": (1, 1), "groups": 1, "dtype": "float32"},
            ]
        return resnet50_conv_contexts()


def resnet50_conv_contexts(batch: int = 32,
                           dtypes=("float32", "bfloat16")) -> List[dict]:
    """ResNet-50's four 3x3 stage geometries (56², 28², 14², 7² at 64,
    128, 256, 512 channels, stride 1, SAME, as ``zoo/models.py`` builds
    its res{2..5} branch2b convs) at ``batch``."""
    out = []
    for dtype in dtypes:
        for hw, c in ((56, 64), (28, 128), (14, 256), (7, 512)):
            out.append({"x_shape": (batch, hw, hw, c),
                        "w_shape": (3, 3, c, c), "strides": (1, 1),
                        "padding": "SAME", "dilation": (1, 1), "groups": 1,
                        "dtype": dtype})
    return out


# ------------------------------------------------------ lstm tile space
class LstmTileSpace(SearchSpace):
    """The LSTM segment: the plain per-step loop (``exact``) or the
    segment kernel whole (``cuda:bt=whole``), per (B, H) geometry. Context:
    ``{"batch", "hidden", "timesteps", "dtype"[, "device"]}``."""

    name = "lstm_tiles"
    op = "lstm_cell"
    tolerance = 1e-4   # LSTM trajectory bound (fp32)

    def signature(self, ctx: dict) -> str:
        from deeplearning4j_tpu_torch.ops.kernels import lstm as klstm

        return klstm.shape_signature(int(ctx["batch"]), int(ctx["hidden"]))

    def enumerate(self, ctx: dict) -> List[Candidate]:
        return [Candidate("exact", impl="exact", is_default=True),
                Candidate("cuda:bt=whole", impl="cuda",
                          params={"b_tile": None})]

    def validate(self, cand: Candidate, ctx: dict) -> Tuple[bool, str]:
        if cand.impl == "exact":
            return True, ""
        if cand.params.get("b_tile") is not None:
            return False, ("the segment kernel's batch tile is fixed by its "
                           "launch geometry")
        return True, ""

    def tolerance_for(self, ctx: dict) -> float:
        return _BF16_TOL if self.dtype(ctx) == "bfloat16" else self.tolerance

    def build(self, ctx: dict) -> MeasureCase:
        import numpy as np
        import torch

        from deeplearning4j_tpu_torch.nn.recurrent import LSTM
        from deeplearning4j_tpu_torch.ops import kernels as K

        b, h = int(ctx["batch"]), int(ctx["hidden"])
        t = int(ctx.get("timesteps", 8))
        n_in = int(ctx.get("n_in", h))
        dev = _device(ctx)
        dtype = _torch_dtype(self.dtype(ctx))
        rng = np.random.default_rng(0)
        lyr = LSTM(n_in=n_in, n_out=h)
        params = {
            "W": torch.as_tensor(rng.normal(size=(n_in, 4 * h)) * 0.1,
                                 dtype=dtype, device=dev),
            "U": torch.as_tensor(rng.normal(size=(h, 4 * h)) * 0.1,
                                 dtype=dtype, device=dev),
            "b": torch.as_tensor(rng.normal(size=(4 * h,)) * 0.1,
                                 dtype=dtype, device=dev)}
        x = torch.as_tensor(rng.normal(size=(b, t, n_in)) * 0.5, dtype=dtype,
                            device=dev)
        carry = lyr.init_carry(b, dtype, dev)
        cuda = dev.type == "cuda"

        def run(cand: Candidate):
            # the two outcomes of the layer's dispatch, forward and
            # backward; on the CPU the kernel candidate takes the
            # segment Function over the kernel's plain version
            p = {k: v.detach().requires_grad_(True) for k, v in
                 params.items()}
            xx = x.detach().requires_grad_(True)
            if cand.impl == "exact":
                with K.impl_scope("exact"):
                    y, _ = lyr.apply_seq(p, xx, carry)
            elif cuda:
                with K.impl_scope("cuda"):
                    y, _ = lyr.apply_seq(p, xx, carry)
            else:
                from deeplearning4j_tpu_torch.ops.kernels import lstm as kl

                xp = torch.matmul(xx, p["W"]) + p["b"]
                y, _ = kl.lstm_seq(xp, carry[0], carry[1], p["U"],
                                   kl.ORDER_IFOG)
            loss = torch.cos(y.float()).sum()
            gx, gu = torch.autograd.grad(loss, [xx, p["U"]])
            return loss.detach(), gx, gu

        def outputs(cand: Candidate):
            return run(cand)

        def timer(cand: Candidate):
            return lambda: run(cand)

        return MeasureCase(
            reference=lambda: outputs(Candidate("exact", impl="exact")),
            outputs=outputs, timer=timer, tolerance=self.tolerance_for(ctx),
            sync=_sync_for(dev))

    def default_contexts(self) -> List[dict]:
        import torch

        if not torch.cuda.is_available():
            return [{"batch": 8, "hidden": 16, "timesteps": 6,
                     "dtype": "float32"}]
        # the char-RNN's geometry (zoo TextGenerationLSTM: TBPTT 50, 256)
        return [{"batch": 32, "hidden": 256, "timesteps": 50,
                 "n_in": 256, "dtype": "float32"}]


# --------------------------------------------------- remat policy space
class RematPolicySpace(SearchSpace):
    """The train step's selective-remat policy (conf scope, reference
    ``:454``): every name ``util/xla_tuning.policy_names()`` registers is a
    candidate, user-registered ones included. Measured on a small conv
    net's whole ``_fit_batch`` on the card; the gate is the 3-step loss
    within the fp32 reassociation bound. The winner lands under the
    ``conf-default`` signature the conf builders consult."""

    name = "remat_policy"
    op = "remat_policy"
    scope = "conf"
    tolerance = 5e-4   # fp32 trajectory wobble over k steps

    def signature(self, ctx: dict) -> str:
        return "conf-default"

    def dtype(self, ctx: dict) -> str:
        return "any"

    def enumerate(self, ctx: dict) -> List[Candidate]:
        from deeplearning4j_tpu_torch.util import xla_tuning

        return [Candidate(f"policy:{name}", impl="conf",
                          params={"remat_policy": None if name == "none"
                                  else name},
                          is_default=(name == "none"))
                for name in xla_tuning.policy_names()]

    @staticmethod
    def _net(policy, device, seed: int = 7):
        from deeplearning4j_tpu_torch.nn import layers as L
        from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = (NeuralNetConfiguration.builder()
                .seed(seed).updater({"@updater": "Sgd",
                                     "learning_rate": 0.05})
                .list()
                .layer(L.ConvolutionLayer(n_out=8, kernel_size=(3, 3)))
                .stage_boundary()
                .layer(L.ConvolutionLayer(n_out=8, kernel_size=(3, 3)))
                .stage_boundary()
                .layer(L.DenseLayer(n_out=16))
                .layer(L.OutputLayer(n_out=4, loss="mcxent",
                                     activation="softmax"))
                .set_input_type((12, 12, 3))
                .build())
        conf.knobs["remat_policy"] = policy
        return MultiLayerNetwork(conf).init(device=device)

    def build(self, ctx: dict) -> MeasureCase:
        import numpy as np
        import torch

        steps = int(ctx.get("steps", 3))
        dev = _device(ctx)
        rng = np.random.default_rng(3)
        x = torch.as_tensor(rng.normal(size=(8, 12, 12, 3)),
                            dtype=torch.float32, device=dev)
        y = torch.as_tensor(np.eye(4, dtype=np.float32)[
            rng.integers(0, 4, size=8)], device=dev)

        def trajectory(cand: Candidate):
            net = self._net(cand.params.get("remat_policy"), dev)
            for _ in range(steps):
                net._fit_batch(x, y)
            return (net.score_value.detach().reshape(1).clone(),)

        nets: Dict[str, Any] = {}

        def timer(cand: Candidate):
            if cand.label not in nets:
                net = self._net(cand.params.get("remat_policy"), dev)
                for _ in range(2):  # past the program's build
                    net._fit_batch(x, y)
                nets[cand.label] = net
            net = nets[cand.label]
            return lambda: net._fit_batch(x, y)

        return MeasureCase(
            reference=lambda: trajectory(
                Candidate("policy:none", impl="conf",
                          params={"remat_policy": None})),
            outputs=trajectory, timer=timer, tolerance=self.tolerance,
            sync=_sync_for(dev))

    def default_contexts(self) -> List[dict]:
        return [{"steps": 3}]


# ------------------------------------------------- declared-only spaces
class XlaFlagsSpace(SearchSpace):
    """The reference's XLA flag candidates
    (``util/xla_tuning.XLA_FLAG_CANDIDATES``; reference ``:561``). The
    port runs no XLA, so every candidate but the default is reported
    invalid ("no XLA"), as the reference's sweep records TPU flags
    rejected on the CPU backend."""

    name = "xla_flags"
    op = "xla_flags"
    scope = "conf"
    measurable = False
    requires = "an XLA backend (this build has none)"

    def signature(self, ctx: dict) -> str:
        return "conf-default"

    def dtype(self, ctx: dict) -> str:
        return "any"

    def enumerate(self, ctx: dict) -> List[Candidate]:
        from deeplearning4j_tpu_torch.util import xla_tuning

        out = [Candidate("flags:none", impl="conf",
                         params={"xla_flags": ""}, is_default=True)]
        for name, flag in xla_tuning.XLA_FLAG_CANDIDATES:
            out.append(Candidate(name, impl="conf",
                                 params={"xla_flags": flag}))
        return out

    def validate(self, cand: Candidate, ctx: dict) -> Tuple[bool, str]:
        if not cand.params.get("xla_flags"):
            return True, ""
        return False, (f"no XLA: {cand.params['xla_flags']} has no "
                       "backend to configure on this build")


class BucketSetSpace(SearchSpace):
    """Shape-bucket candidate sets (``data/bucketing.py``). Ranking needs
    the workload's real length distribution (pad waste against programs
    built is a property of the data, not the op), so this space declares
    the candidates and the key shape."""

    name = "bucket_sets"
    op = "bucket_sets"
    scope = "conf"
    measurable = False
    requires = "a recorded ragged-length distribution"

    def signature(self, ctx: dict) -> str:
        dist = ctx.get("length_histogram")
        if dist:
            return "hist=" + ",".join(f"{k}:{v}"
                                      for k, v in sorted(dist.items()))
        return "conf-default"

    def dtype(self, ctx: dict) -> str:
        return "any"

    def enumerate(self, ctx: dict) -> List[Candidate]:
        return [Candidate("buckets:pow2", impl="conf",
                          params={"batch_buckets": "pow2"},
                          is_default=True),
                Candidate("buckets:8-16-32", impl="conf",
                          params={"batch_buckets": [8, 16, 32]}),
                Candidate("buckets:16-64", impl="conf",
                          params={"batch_buckets": [16, 64]})]


# --------------------------------------------------- prefill chunk space
class PrefillChunkSpace(SearchSpace):
    """Chunked-prefill window width of the paged decode engine
    (``serving/generate.py`` ``prefill_chunk``): small chunks bound the
    decode lane's head-of-line blocking, the whole-prompt prefill
    amortises dispatch best. The gate is generated-token identity
    (tolerance 0). Context: ``{"max_length", "prompt_len", "batch",
    "max_new"[, "device"]}``."""

    name = "prefill_chunk"
    op = "prefill_chunk"
    scope = "conf"
    tolerance = 0.0    # token ids: identity or rejection

    def signature(self, ctx: dict) -> str:
        return (f"maxlen={int(ctx.get('max_length', 64))}"
                f",prompt={int(ctx.get('prompt_len', 24))}")

    def dtype(self, ctx: dict) -> str:
        return "int32"

    def enumerate(self, ctx: dict) -> List[Candidate]:
        max_length = int(ctx.get("max_length", 64))
        out = [Candidate("chunk:whole", impl="conf",
                         params={"prefill_chunk": None}, is_default=True)]
        w = 4
        while w < max_length:
            out.append(Candidate(f"chunk:{w}", impl="conf",
                                 params={"prefill_chunk": w}))
            w *= 2
        return out

    def validate(self, cand: Candidate, ctx: dict) -> Tuple[bool, str]:
        w = cand.params.get("prefill_chunk")
        if w is None:
            return True, ""
        max_length = int(ctx.get("max_length", 64))
        if not 1 <= int(w) <= max_length:
            return False, f"chunk {w} outside [1, max_length={max_length}]"
        return True, ""

    def neighbors(self, cand: Candidate, ctx: dict) -> List[Candidate]:
        if cand.params.get("prefill_chunk") is None:
            return []
        all_c = [c for c in self.enumerate(ctx)
                 if c.params.get("prefill_chunk") is not None]
        widths = [c.params.get("prefill_chunk") for c in all_c]
        try:
            i = widths.index(cand.params.get("prefill_chunk"))
        except ValueError:
            return []
        return [all_c[j] for j in (i - 1, i + 1) if 0 <= j < len(all_c)]

    def build(self, ctx: dict) -> MeasureCase:
        import numpy as np
        import torch

        from deeplearning4j_tpu_torch.serving.generate import Generator
        from deeplearning4j_tpu_torch.zoo.bert import Bert

        max_length = int(ctx.get("max_length", 64))
        prompt_len = int(ctx.get("prompt_len", 24))
        batch = int(ctx.get("batch", 2))
        max_new = int(ctx.get("max_new", 8))
        dev = _device(ctx)
        vocab = 61
        net = Bert.tiny(causal=True, task="mlm", vocab_size=vocab,
                        max_length=max_length,
                        hidden_dropout=0.0).init(device=dev)
        rng = np.random.default_rng(11)
        prompts = [[int(t) for t in rng.integers(1, vocab, prompt_len)]
                   for _ in range(batch)]
        gens: Dict[str, Generator] = {}

        def gen_for(cand: Candidate) -> Generator:
            if cand.label not in gens:
                g = Generator(net, paged=True, block_size=4,
                              batch_buckets=(batch,),
                              prefill_buckets=(max_length,),
                              prefill_chunk=cand.params.get("prefill_chunk"))
                g.generate(prompts, max_new_tokens=max_new)  # warm
                gens[cand.label] = g
            return gens[cand.label]

        def outputs(cand: Candidate):
            toks = gen_for(cand).generate(prompts, max_new_tokens=max_new)
            arr = np.full((batch, max_new), -1, np.int32)
            for i, row in enumerate(toks):
                arr[i, :len(row)] = row
            return (torch.as_tensor(arr),)

        def timer(cand: Candidate):
            g = gen_for(cand)
            return lambda: g.generate(prompts, max_new_tokens=max_new)

        return MeasureCase(
            reference=lambda: outputs(
                Candidate("chunk:whole", impl="conf",
                          params={"prefill_chunk": None})),
            outputs=outputs, timer=timer, tolerance=self.tolerance,
            sync=_sync_for(dev))

    def default_contexts(self) -> List[dict]:
        import torch

        if not torch.cuda.is_available():
            return [{"max_length": 32, "prompt_len": 20, "batch": 2,
                     "max_new": 4}]
        return [{"max_length": 2048, "prompt_len": 1536, "batch": 8,
                 "max_new": 32}]


# ------------------------------------------------- affinity head space
class AffinityHeadSpace(SearchSpace):
    """The prompt-head length the fleet router hashes for prefix affinity
    (``serving/fleet.py`` ``affinity_head``, ``DL4J_TPU_AFFINITY_HEAD``).
    head:0 turns affinity off (best load spread, every worker cold on
    every prefix); a short head piles distinct system prompts on one
    worker; a long head splits requests that share a cached prefix.
    Ranking needs a live multi-worker fleet under representative
    shared-prefix traffic, so the space is declared, not measurable in one
    process."""

    name = "affinity_head"
    op = "affinity_head"
    scope = "conf"
    measurable = False
    requires = ("a live multi-process fleet + representative shared-"
                "prefix traffic trace (the objective — fleet QPS / "
                "aggregate prefix hit rate vs load skew — only exists "
                "at fleet scope)")

    def signature(self, ctx: dict) -> str:
        return f"workers={int(ctx.get('n_workers', 2))}"

    def dtype(self, ctx: dict) -> str:
        return "any"

    def enumerate(self, ctx: dict) -> List[Candidate]:
        from deeplearning4j_tpu_torch.serving.fleet import \
            DEFAULT_AFFINITY_HEAD

        out = [Candidate("head:0", impl="conf",
                         params={"affinity_head": 0})]  # no affinity
        for head in (4, 8, 16, 32, 64):
            out.append(Candidate(
                f"head:{head}", impl="conf",
                params={"affinity_head": head},
                is_default=head == DEFAULT_AFFINITY_HEAD))
        return out


# --------------------------------------------- compression hosts space
class CompressionHostsSpace(SearchSpace):
    """Hierarchical gradient-compression host counts (reference ``:627``;
    ``parallel/compression.py``, ``ParallelWrapper(compression_hosts=)``):
    full-precision combines within a host, the encoded exchange across
    hosts. The wire bytes are deterministic, but ranking wire against
    encode cost needs real hosts on a real interconnect (ROADMAP item
    10c), so the space is declared with the reference's candidates."""

    name = "compression_hosts"
    op = "compression_hosts"
    scope = "conf"
    measurable = False
    requires = ("real multi-host links (one process cannot rank wire "
                "against encode cost)")

    def signature(self, ctx: dict) -> str:
        return "conf-default"

    def dtype(self, ctx: dict) -> str:
        return "any"

    def enumerate(self, ctx: dict) -> List[Candidate]:
        out = [Candidate("hosts:auto", impl="conf",
                         params={"compression_hosts": "auto"},
                         is_default=True)]
        for n in (1, 2, 4):
            out.append(Candidate(f"hosts:{n}", impl="conf",
                                 params={"compression_hosts": n}))
        return out


# --------------------------------------------- pipeline schedule space
class PipeScheduleSpace(SearchSpace):
    """Pipeline-schedule candidates of ``PipelinedTrainer`` (reference
    ``:656``): microbatch counts (bubble fraction (S-1)/(n_micro+S-1)
    against live activations) x the schedule family (the GPipe fill-drain
    schedule it runs, and a 1F1B candidate). On one device the stages run
    one after another, so the bubble costs no time and the ranking needs
    stages on devices of their own; the space is declared with the
    reference's candidates."""

    name = "pipe_schedule"
    op = "pipe_schedule"
    scope = "conf"
    measurable = False
    requires = ("stages placed on devices of their own (one device runs "
                "the stages in turn, so the bubble costs no time; 1f1b "
                "candidates also need the interleaved schedule)")

    def signature(self, ctx: dict) -> str:
        return f"stages={int(ctx.get('pipe_stages', 2))}"

    def dtype(self, ctx: dict) -> str:
        return "any"

    def enumerate(self, ctx: dict) -> List[Candidate]:
        from deeplearning4j_tpu_torch.parallel.pipeline import \
            bubble_fraction

        s = int(ctx.get("pipe_stages", 2))
        out = []
        for sched in ("gpipe", "1f1b"):
            for mult in (1, 2, 4, 8):
                n_micro = s * mult
                out.append(Candidate(
                    f"{sched}:m{n_micro}", impl="conf",
                    params={"pipe_schedule": sched, "n_micro": n_micro,
                            "bubble_fraction": bubble_fraction(s, n_micro)},
                    is_default=(sched == "gpipe" and mult == 1)))
        return out


# ------------------------------------------------------- default wiring
register_space(ConvTileSpace())
register_space(LstmTileSpace())
register_space(BucketSetSpace())
register_space(PrefillChunkSpace())
register_space(AffinityHeadSpace())
register_space(RematPolicySpace())
register_space(XlaFlagsSpace())
register_space(CompressionHostsSpace())
register_space(PipeScheduleSpace())
