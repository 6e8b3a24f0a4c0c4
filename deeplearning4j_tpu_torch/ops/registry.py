"""The op table (mirrors deeplearning4j_tpu/ops/registry.py:39-151).

Ops are plain functions on tensors, registered by name so that by-name
callers (``nn/activations.resolve``, ``exec_op``) find them as they do in
the reference. Only the ops of the ported slices are registered; a name
the reference has and the port does not yet raises
:class:`OpNotFoundError`.
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
    doc: str = ""

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


_REGISTRY: Dict[str, OpDef] = {}
_ALIASES: Dict[str, str] = {}


class OpNotFoundError(KeyError):
    pass


def register(name: str, fn: Callable[..., Any], *, category: str,
             aliases: Iterable[str] = (), doc: str = "") -> OpDef:
    """Register an op; the last registration of a name wins."""
    opdef = OpDef(name=name, fn=fn, category=category,
                  aliases=tuple(aliases), doc=doc or (fn.__doc__ or ""))
    _REGISTRY[name] = opdef
    for alias in opdef.aliases:
        _ALIASES[alias] = name
    return opdef


def op(name: str, category: str, *, aliases: Iterable[str] = ()):
    """Decorator form of :func:`register`; returns the function unchanged."""

    def wrap(fn: Callable) -> Callable:
        register(name, fn, category=category, aliases=aliases)
        return fn

    return wrap


def get_op(name: str) -> OpDef:
    key = name if name in _REGISTRY else _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise OpNotFoundError(
            f"Op {name!r} is not registered in the port (have "
            f"{len(_REGISTRY)} ops; see ROADMAP.md for what is still to "
            "port)") from None


def has_op(name: str) -> bool:
    return name in _REGISTRY or name in _ALIASES


def exec_op(name: str, *args, **kwargs):
    """Execute an op by name (``OpExecutioner.exec`` parity)."""
    return get_op(name)(*args, **kwargs)


def list_ops(category: Optional[str] = None) -> list:
    if category is None:
        return sorted(_REGISTRY)
    return sorted(n for n, o in _REGISTRY.items() if o.category == category)
