"""Run the reference's own test cases on the port.

``port_copy(name)`` reads ``tests/<name>.py`` (a test module of the JAX
package), points every import of ``deeplearning4j_tpu`` at
``deeplearning4j_tpu_torch``, makes the port's CPU-only differences explicit
(``init()`` takes ``device="cpu"``; ``AsyncDataSetIterator`` stages onto
``device="cpu"``, the port having no default device without a card), and
loads the result as a module of its own. ``expose(module, names, into)``
puts the chosen test functions, test classes and every fixture of that
module into a test file's namespace, where pytest collects them: each
reference case then runs once on the reference (in its own file) and once
on the port (in the ``test_torch_*`` file that exposes it).
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

_PRELUDE = '''
def _port_async(*args, **kwargs):
    from deeplearning4j_tpu_torch.data.prefetch import AsyncDataSetIterator
    kwargs.setdefault("device", "cpu")
    return AsyncDataSetIterator(*args, **kwargs)

'''


def port_source(name: str, drop=(), replace=()) -> str:
    """The source of ``tests/<name>.py`` rewritten for the port: lines
    containing any string of ``drop`` are removed, then each (old, new) of
    ``replace`` is applied."""
    with open(os.path.join(HERE, f"{name}.py")) as f:
        lines = [ln for ln in f.read().splitlines(keepends=True)
                 if not any(d in ln for d in drop)]
    src = "".join(lines)
    src = re.sub(r"\bdeeplearning4j_tpu\b(?!_torch)",
                 "deeplearning4j_tpu_torch", src)
    src = src.replace(".init()", '.init(device="cpu")')
    src = re.sub(r"\bAsyncDataSetIterator\(", "_port_async(", src)
    for old, new in replace:
        src = src.replace(old, new)
    # the prelude goes after the module docstring and __future__ imports
    m = re.search(r"^(import|from) (?!__future__)", src, re.M)
    at = m.start() if m else 0
    return src[:at] + _PRELUDE + src[at:]


def port_copy(name: str, drop=(), replace=()):
    """``tests/<name>.py`` rewritten for the port (:func:`port_source`),
    loaded once as the module ``_port_<name>``."""
    mod_name = f"_port_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_loader(mod_name, loader=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = os.path.join(HERE, f"{name}.py")
    sys.modules[mod_name] = mod
    exec(compile(port_source(name, drop, replace), mod.__file__, "exec"),
         mod.__dict__)
    return mod


def expose(mod, names, into: dict) -> None:
    """Put ``names`` (test functions and classes of ``mod``) and every
    fixture of ``mod`` into the namespace ``into``."""
    for n in names:
        into[n] = getattr(mod, n)
    for n, v in vars(mod).items():
        if hasattr(v, "_fixture_function_marker") or \
                type(v).__name__ == "FixtureFunctionDefinition":
            into.setdefault(n, v)
