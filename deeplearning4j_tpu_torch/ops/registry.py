"""The op table (mirrors deeplearning4j_tpu/ops/registry.py:39-151).

Ops are plain functions on tensors, registered by name so that by-name
callers (``nn/activations.resolve``, ``exec_op``, graph importers) find
them as they do in the reference: every name, alias and category of the
reference's table, in its families' import order, so the last
registration of a name wins as it does there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional


@dataclasses.dataclass(frozen=True)
class OpDef:
    """A registered op: name -> function + metadata."""

    name: str
    fn: Callable[..., Any]
    category: str
    aliases: tuple = ()
    differentiable: bool = True
    doc: str = ""

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


_REGISTRY: Dict[str, OpDef] = {}
_ALIASES: Dict[str, str] = {}


class OpNotFoundError(KeyError):
    pass


def register(name: str, fn: Callable[..., Any], *, category: str,
             aliases: Iterable[str] = (), differentiable: bool = True,
             doc: str = "") -> OpDef:
    """Register an op; the last registration of a name wins."""
    opdef = OpDef(name=name, fn=fn, category=category,
                  aliases=tuple(aliases), differentiable=differentiable,
                  doc=doc or (fn.__doc__ or ""))
    _REGISTRY[name] = opdef
    for alias in opdef.aliases:
        _ALIASES[alias] = name
    return opdef


def op(name: str, category: str, *, aliases: Iterable[str] = (),
       differentiable: bool = True):
    """Decorator form of :func:`register`; returns the function unchanged."""

    def wrap(fn: Callable) -> Callable:
        register(name, fn, category=category, aliases=aliases,
                 differentiable=differentiable)
        return fn

    return wrap


def add_alias(alias: str, name: str) -> None:
    """Register an extra name for an existing op."""
    if name not in _REGISTRY:
        raise OpNotFoundError(name)
    _ALIASES[alias] = name


def get_op(name: str) -> OpDef:
    key = name if name in _REGISTRY else _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise OpNotFoundError(
            f"Op {name!r} is not registered (have {len(_REGISTRY)} ops)"
        ) from None


def has_op(name: str) -> bool:
    return name in _REGISTRY or name in _ALIASES


def exec_op(name: str, *args, **kwargs):
    """Execute an op by name (``OpExecutioner.exec`` parity)."""
    return get_op(name)(*args, **kwargs)


def list_ops(category: Optional[str] = None) -> list:
    if category is None:
        return sorted(_REGISTRY)
    return sorted(n for n, o in _REGISTRY.items() if o.category == category)


def aliases() -> Dict[str, str]:
    """alias -> canonical name, for every alias registered."""
    return dict(_ALIASES)


def categories() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for o in _REGISTRY.values():
        out[o.category] = out.get(o.category, 0) + 1
    return out


def op_count() -> int:
    return len(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and type of an op's output, as :func:`shape_of` reports it."""

    shape: tuple
    dtype: Any


def shape_of(name: str, *args, **kwargs):
    """Output shapes and types of an op without computing its values: each
    positional :class:`ShapeDtype` (or tensor) becomes a tensor on the
    ``meta`` device, the op runs there, and every tensor of its result
    comes back as a :class:`ShapeDtype` (nested as the result is). kwargs
    are static configuration."""
    import torch

    def meta(a):
        if isinstance(a, ShapeDtype):
            return torch.empty(a.shape, dtype=a.dtype, device="meta")
        if isinstance(a, torch.Tensor):
            return torch.empty(a.shape, dtype=a.dtype, device="meta")
        return a

    def spec(o):
        if isinstance(o, torch.Tensor):
            return ShapeDtype(tuple(o.shape), o.dtype)
        if isinstance(o, (list, tuple)):
            return type(o)(spec(v) for v in o)
        return o

    return spec(get_op(name).fn(*(meta(a) for a in args), **kwargs))
