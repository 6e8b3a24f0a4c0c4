"""The port's ``torch.distributed`` bootstrap (``parallel/distributed.py``)
on the CPU: a single-process ``initialize`` on gloo over a TCP
coordinator, the no-op without one, retries on a refused coordinator
until the policy is spent, and the one-process surfaces (``global_mesh``,
``process_index``, ``host_count``, ``is_coordinator``) beside the
reference's."""

import socket

import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.parallel import distributed as JD  # noqa: E402
from deeplearning4j_tpu_torch.parallel import distributed as TD  # noqa: E402
from deeplearning4j_tpu_torch.util.faults import (  # noqa: E402
    RetryExhaustedError, RetryPolicy)
from deeplearning4j_tpu_torch.util import telemetry as tm  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_group():
    TD.shutdown()
    yield
    TD.shutdown()


def test_single_process_without_coordinator_is_a_noop(clean_group):
    TD.initialize()
    TD.initialize(num_processes=1)
    JD.initialize()
    assert not torch.distributed.is_initialized()
    assert (TD.process_index(), TD.process_count()) == (0, 1)
    assert TD.process_index() == JD.process_index()
    assert TD.host_count() == JD.host_count() == 1
    assert TD.is_coordinator() and JD.is_coordinator()
    with pytest.raises(ValueError, match="coordinator"):
        TD.initialize(num_processes=2)


def test_initialize_single_process_on_gloo(clean_group):
    TD.initialize(coordinator=f"127.0.0.1:{_free_port()}", num_processes=1,
                  process_id=0)
    assert torch.distributed.is_initialized()
    assert torch.distributed.get_backend() == "gloo"
    assert (TD.process_index(), TD.process_count()) == (0, 1)
    t = torch.ones(3)
    torch.distributed.all_reduce(t)  # a collective of one rank
    assert t.tolist() == [1.0, 1.0, 1.0]
    TD.initialize(coordinator="127.0.0.1:1", num_processes=1)  # no-op now
    mesh = TD.global_mesh(device="cpu")
    assert mesh.n_devices == 1 and mesh.device.type == "cpu"
    TD.shutdown()
    assert not torch.distributed.is_initialized()


def test_refused_coordinator_is_retried_then_fails(clean_group,
                                                   monkeypatch):
    """Rank 1 dials a coordinator nobody serves: each attempt times out,
    the policy retries, then raises with the cause."""
    before = tm.get_telemetry().counter_total("elastic.retries_total")
    monkeypatch.setattr(TD, "HANDSHAKE_TIMEOUT_S", 1.0)
    policy = RetryPolicy(max_attempts=2, base_delay=0.01, max_delay=0.01,
                         jitter=0.0)
    with pytest.raises(RetryExhaustedError, match="dcn_bootstrap"):
        TD.initialize(coordinator=f"127.0.0.1:{_free_port()}",
                      num_processes=2, process_id=1, retry=policy)
    assert not torch.distributed.is_initialized()
    assert tm.get_telemetry().counter_total(
        "elastic.retries_total") >= before + 1
    assert TD.BOOTSTRAP_RETRY.delays() == JD.BOOTSTRAP_RETRY.delays()


def test_global_mesh_of_several_processes_names_item_10c(monkeypatch):
    monkeypatch.setattr(TD, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="10c"):
        TD.global_mesh()


def test_default_backend():
    assert TD.default_backend("cpu") == "gloo"
    assert TD.default_backend("cuda:0") == "nccl"
