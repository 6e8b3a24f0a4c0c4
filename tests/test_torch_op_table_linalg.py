"""The op table by name, the linalg and random families: every op's seeded case
(``deeplearning4j_tpu_torch/ops/op_cases.py``) through the reference's
``exec_op`` and the port's on the CPU, held to each other as the case says
(its family's tolerance in ``op_cases.TOLERANCES``; random ops by shape,
type and moments; decompositions by reconstruction and spectrum)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.ops as ref_ops  # noqa: E402
import deeplearning4j_tpu_torch.ops as port_ops  # noqa: E402
from deeplearning4j_tpu_torch.ops import op_cases as oc  # noqa: E402

FAMILIES = ('linalg', 'random')
CASES = oc.build(0)
NAMES = sorted(n for n, c in CASES.items() if c.family in FAMILIES)


def _reference(name, case):
    return oc.to_numpy(oc.run(ref_ops.exec_op, name, case, jnp.asarray,
                              lambda k: jax.random.PRNGKey(k.seed)))


def _port(name, case):
    return oc.to_numpy(oc.run(
        port_ops.exec_op, name, case,
        lambda a: torch.from_numpy(np.array(a, copy=True)),
        lambda k: torch.Generator().manual_seed(k.seed)))


def test_family_is_covered():
    want = {n for n in ref_ops.list_ops()
            if ref_ops.get_op(n).fn.__module__.rsplit(".", 1)[-1]
            in FAMILIES}
    assert want <= set(NAMES), sorted(want - set(NAMES))


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference(name):
    case = CASES[name]
    oc.compare(case, _port(name, case), _reference(name, case))
