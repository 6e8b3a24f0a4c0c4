"""ModelSerializer archives (counterpart of
deeplearning4j_tpu/util/model_serializer.py; ModelSerializer.java).

An archive is a zip of ``configuration.json`` (the conf JSON, which both
packages read), ``coefficients.npz``, ``state.npz`` and optionally
``updaterState.npz`` (one ``arr_i`` per leaf), ``meta.json`` and optionally
``normalizer.json``. The leaves are in ``jax.tree_util`` flatten order:
dict keys sorted, lists and tuples in order, ``()``, ``{}`` and None with no
leaves; ``meta.json``'s ``params_structure`` is the string
``jax.tree_util.tree_structure(params)`` prints, built here from the same
rule, and a restore refuses an archive whose string differs from the one
of the net its configuration builds. So either package restores an
archive the other wrote, with the iteration, the epoch, the optimizer
state and the normalizer; nothing here knows a layer, so the trees of
every ported layer class (``nn/layers_spatial.py``'s and the Keras
importer's networks included) cross as they are.

Random streams do not cross: ``meta.json`` carries the reference's
``rng_key`` (``[0, seed]``, the key ``PRNGKey(conf.seed)`` is, for a net
the port initialized; the key it was given for a net restored from the
reference's archive), and the port's own dropout generator state rides in
an extra member, ``torchGenerator.npz``, which the reference does not read.
Within the port a restored net resumes bit for bit; the generator state
is taken only onto a device of the type it was saved from (on another it
stays seeded from ``conf.seed``).

Int8 serving archives (``write_model(..., quantize="int8")``, reference
``:86-121``): the weight matrices and tables as int8 with per-channel fp32
scales in ``quantScales.npz`` (size-0 arrays for the pass-through leaves),
no updater state. A restore dequantizes them into an fp32 net and keeps
the stored leaves on ``net._int8_archive`` (reference ``:241-259``), so
``ModelRouter.load(quantize="int8")`` serves the archive's own
quantization, bit for bit. Either package restores the other's int8
archives.

Restores build the net on ``device`` (CUDA unless the caller names
another, as at every entry point) and copy each archived leaf into the
fresh net's tensor in place; the net's captured programs are dropped.
A sharded training checkpoint (``util/checkpoint.py``) is read only by the
package that wrote it; this archive is the interchange.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_CONFIG = "configuration.json"
_COEFF = "coefficients.npz"
_STATE = "state.npz"
_UPDATER = "updaterState.npz"
_META = "meta.json"
_NORMALIZER = "normalizer.json"
_GENERATOR = "torchGenerator.npz"
_SCALES = "quantScales.npz"  # int8 archives: per-channel scales


# --------------------------------------------------------------- the trees


def jax_items(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) in jax.tree_util flatten order: dict keys sorted,
    lists and tuples in order, None and empty containers leafless."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in jax_items(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in jax_items(v, prefix + (i,))]
    return [(prefix, tree)]


def _treedef(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def fingerprint(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists, tuples, None and leaves."""
    return f"PyTreeDef({_treedef(tree)})"


def _host(t) -> np.ndarray:
    """A host copy of ``t``: never a view of a CPU tensor, which the next
    step updates in place (an async checkpoint or a publish snapshot would
    then write a later step's values)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif t.device.type == "cpu":
            t = t.clone()
        return t.cpu().numpy()
    return np.asarray(t)


def _leaves(tree) -> list:
    return [_host(v) for _, v in jax_items(tree)]


def _savez(leaves) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, *leaves)
    return buf.getvalue()


def _loadz(data: bytes) -> list:
    z = np.load(io.BytesIO(data))
    return [z[f"arr_{i}"] for i in range(len(z.files))]


def _refill(name: str, tree, leaves) -> None:
    """Copy archived leaves into the live tree's tensors, in place, in
    jax order; the counts and shapes must match."""
    items = jax_items(tree)
    if len(items) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} {name} arrays, model "
                         f"needs {len(items)} (configuration mismatch)")
    for i, ((path, dst), src) in enumerate(zip(items, leaves)):
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"checkpoint {name} array {i} {list(path)} has shape "
                f"{tuple(src.shape)}, model expects {tuple(dst.shape)} "
                "(configuration mismatch)")
        with torch.no_grad():
            # np.array keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
            dst.copy_(torch.from_numpy(np.array(src, order="C")))


def _model_type(model) -> str:
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if isinstance(model, MultiLayerNetwork):
        return "MultiLayerNetwork"
    if isinstance(model, ComputationGraph):
        return "ComputationGraph"
    raise TypeError(f"cannot serialize {type(model).__name__}")


def _reference_key(model) -> list:
    """The reference's ``_rng_key`` for this net: the one an archive gave
    it, else ``PRNGKey(conf.seed)`` ([seed >> 32, seed & 0xffffffff],
    the high word dropped as 32-bit JAX drops it)."""
    key = getattr(model, "_reference_rng_key", None)
    if key is not None:
        return list(key)
    return [0, int(model.conf.seed) & 0xFFFFFFFF]


def _meta(model, has_updater: bool) -> dict:
    gen = getattr(model, "_gen", None)
    return {
        "type": _model_type(model),
        "iteration": int(model.iteration),
        "epoch": int(model.epoch),
        "rng_key": _reference_key(model),
        "params_structure": fingerprint(model.params),
        "has_updater_state": bool(has_updater),
        "format_version": 1,
        "torch_generator_device": None if gen is None else gen.device.type,
    }


def _generator_state(model):
    gen = getattr(model, "_gen", None)
    return None if gen is None else gen.get_state().numpy()


class ModelSerializer:
    """Static save/restore API (ModelSerializer.java parity)."""

    # ------------------------------------------------------------------ save
    @staticmethod
    def write_model(model, path: str, save_updater: bool = True,
                    normalizer=None, quantize: Optional[str] = None) -> None:
        """Write ``model`` to ``path`` (atomically). ``quantize="int8"``
        writes a weight-only int8 serving archive (module doc) and no
        updater state."""
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        snap = ModelSerializer.snapshot(model, save_updater and
                                        quantize is None)
        if quantize == "int8":
            from deeplearning4j_tpu_torch.serving.quantize import \
                QuantizedParams

            qp = QuantizedParams.from_params(snap["params"])
            snap["meta"].update(quantize="int8", fp32_bytes=qp.fp32_bytes())
            snap["int8"] = qp
        ModelSerializer._write_zip(path, ModelSerializer._entries(
            snap, normalizer))

    @staticmethod
    def _entries(snap: dict, normalizer=None) -> list:
        qp = snap.get("int8")
        if qp is None:
            entries = [(_CONFIG, snap["conf_json"]),
                       (_COEFF, _savez(_leaves(snap["params"]))),
                       (_STATE, _savez(_leaves(snap["states"])))]
        else:  # pass-through leaves' scales ride as size-0 arrays
            entries = [(_CONFIG, snap["conf_json"]),
                       (_COEFF, _savez(qp.qleaves)),
                       (_SCALES, _savez([
                           np.zeros(0, np.float32) if sc is None else sc
                           for sc in qp.scales])),
                       (_STATE, _savez(_leaves(snap["states"])))]
        if snap.get("opt_states") is not None:
            entries.append((_UPDATER, _savez(_leaves(snap["opt_states"]))))
        entries.append((_META, json.dumps(snap["meta"])))
        if snap.get("generator") is not None:
            entries.append((_GENERATOR, _savez([snap["generator"]])))
        if normalizer is not None:
            entries.append((_NORMALIZER, json.dumps(normalizer.to_dict())))
        return entries

    @staticmethod
    def _write_zip(path: str, entries) -> None:
        """Atomic publish: the whole zip to a temporary sibling, then
        ``os.replace`` into place, so a reader never sees a torn archive
        and a crash mid-write leaves only the temporary file. The members
        are stored, not deflated: random-looking fp32 weights deflate by a
        few percent for seconds of host time per hundred megabytes, and zip
        readers, the reference's included, read either."""
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
                for name, data in entries:
                    zf.writestr(name, data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # ------------------------------------------------------------- snapshot
    @staticmethod
    def snapshot(model, save_updater: bool = False) -> dict:
        """Everything ``write_model`` writes, as host arrays, taken on the
        caller's thread: the training steps update the tensors in place,
        so a writer that held them would follow the training. The
        compression and the write can then run on another thread
        (:meth:`write_snapshot`)."""
        if not hasattr(model, "conf") or model.device is None:
            raise ValueError("init() the network before serializing it")
        return {
            "conf_json": model.conf.to_json(),
            "params": _host_tree(model.params),
            "states": _host_tree(model.states),
            "opt_states": (_host_tree(model.opt_states) if save_updater
                           else None),
            "meta": _meta(model, save_updater),
            "generator": _generator_state(model),
        }

    @staticmethod
    def write_snapshot(snap: dict, path: str, normalizer=None) -> None:
        """Write a :meth:`snapshot` to ``path`` (atomic); safe on any
        thread."""
        ModelSerializer._write_zip(path, ModelSerializer._entries(
            snap, normalizer))

    # --------------------------------------------------------------- restore
    @staticmethod
    def _restore(path: str, expect_type: Optional[str], load_updater: bool,
                 device=None):
        from deeplearning4j_tpu_torch.nn.computation_graph import (
            ComputationGraph, ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read(_META))
            if expect_type and meta["type"] != expect_type:
                raise ValueError(
                    f"archive holds a {meta['type']}, expected {expect_type}")
            cfg_json = zf.read(_CONFIG).decode()
            if meta["type"] == "MultiLayerNetwork":
                net = MultiLayerNetwork(
                    MultiLayerConfiguration.from_json(cfg_json))
            else:
                net = ComputationGraph(
                    ComputationGraphConfiguration.from_json(cfg_json))
            net.init(device=device)
            if meta.get("params_structure") and \
                    meta["params_structure"] != fingerprint(net.params):
                raise ValueError(
                    "checkpoint param structure does not match the model "
                    "built from its configuration (corrupt or hand-edited "
                    "archive)")
            if meta.get("quantize") == "int8":
                ModelSerializer._restore_int8(zf, net)
            else:
                _refill("param", net.params, _loadz(zf.read(_COEFF)))
            _refill("state", net.states, _loadz(zf.read(_STATE)))
            names = zf.namelist()
            if load_updater and meta.get("has_updater_state") and \
                    _UPDATER in names:
                # a fused net's masters are saved and restored with the
                # params (they are leaves of its optimizer state)
                _refill("updater", net.opt_states, _loadz(zf.read(_UPDATER)))
            elif getattr(net, "_fused", None) is not None:
                # the masters were built from init()'s random params:
                # resync them to the loaded ones (reference ``:266-272``),
                # or the first step would put the random params back
                net._fused.resync_masters(net.params, net.opt_states)
            net.iteration = int(meta["iteration"])
            net.epoch = int(meta["epoch"])
            net._reference_rng_key = [int(v) for v in meta["rng_key"]]
            if _GENERATOR in names and net._gen is not None and \
                    meta.get("torch_generator_device") == \
                    net._gen.device.type:
                state = _loadz(zf.read(_GENERATOR))[0]
                net._gen.set_state(torch.from_numpy(state.copy()))
        net._drop_programs()
        return net

    @staticmethod
    def _restore_int8(zf, net) -> None:
        """An int8 archive's params, dequantized into the fp32 net, and
        the stored leaves stashed on ``net._int8_archive`` (reference
        ``:241-259``)."""
        from deeplearning4j_tpu_torch.ops.compression import dequantize_np

        qleaves = _loadz(zf.read(_COEFF))
        scales = [None if sc.size == 0 else sc
                  for sc in _loadz(zf.read(_SCALES))]
        if len(qleaves) != len(scales):
            raise ValueError("int8 archive scale count does not match its "
                             "coefficient count (corrupt archive)")
        _refill("param", net.params,
                [q if sc is None else dequantize_np(q, sc)
                 for q, sc in zip(qleaves, scales)])
        net._int8_archive = (fingerprint(net.params), qleaves, scales)

    @staticmethod
    def peek_meta(path: str) -> dict:
        """The archive's type, iteration, epoch and format version, without
        building the model."""
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read(_META))
        return {k: meta[k] for k in ("type", "iteration", "epoch",
                                     "format_version", "quantize",
                                     "fp32_bytes") if k in meta}

    @staticmethod
    def restore_multi_layer_network(path: str, load_updater: bool = True,
                                    device=None):
        return ModelSerializer._restore(path, "MultiLayerNetwork",
                                        load_updater, device)

    @staticmethod
    def restore_computation_graph(path: str, load_updater: bool = True,
                                  device=None):
        return ModelSerializer._restore(path, "ComputationGraph",
                                        load_updater, device)

    @staticmethod
    def restore_model(path: str, load_updater: bool = True, device=None):
        return ModelSerializer._restore(path, None, load_updater, device)

    # ------------------------------------------------------------ normalizer
    @staticmethod
    def restore_normalizer_from_file(path: str):
        from deeplearning4j_tpu_torch.data.normalizers import \
            normalizer_from_dict

        with zipfile.ZipFile(path, "r") as zf:
            if _NORMALIZER not in zf.namelist():
                return None
            return normalizer_from_dict(json.loads(zf.read(_NORMALIZER)))

    @staticmethod
    def add_normalizer_to_model(path: str, normalizer) -> None:
        """addNormalizerToModel parity: attach one to an archive."""
        with zipfile.ZipFile(path, "a", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(_NORMALIZER, json.dumps(normalizer.to_dict()))


def _host_tree(tree):
    """``tree`` with every tensor as a host numpy array (same nesting)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _host(tree)
