"""ModelSerializer archives between the packages for four
ComputationGraphs, on the CPU: a small residual graph (conv, batchnorm, an
add vertex), the masked Bidirectional(LSTM) graph, Xception at 32x32 with
one middle repeat (the separable convs' ``depthW``/``pointW``) and a
graph with a SharedLayer (a node with no params of its own), each written
by one package and restored by the other, with the checks and tolerances
of ``test_torch_serializer.py`` (whose helpers run them). Xception's
restored net is not then fitted against the reference's: its batchnorms
whose shift a later batchnorm absorbs have gradients at the level of
rounding noise, which Adam turns into steps of its learning rate, so two
further steps of the two packages part by some 5% on those tensors
(tests/test_torch_conv_zoo.py holds its trajectory under Sgd)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_serializer import (  # noqa: E402
    _port_archive_restores_in_the_reference,
    _reference_archive_restores_in_the_port)

GRAPHS = ["resnet_graph", "bidir_graph", "xception", "shared_graph"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread while this module runs: under the suite's six
    workers on eight cores, the OpenMP regions of the port's plain conv
    path oversubscribe the cores and an Xception step takes ~100x its time
    alone (80 s against 0.35 s); on one thread it takes 0.3-0.7 s either
    way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", GRAPHS)
def test_reference_archive_restores_in_the_port(name, tmp_path):
    _reference_archive_restores_in_the_port(name, tmp_path,
                                            then_fit=name != "xception")


@pytest.mark.parametrize("name", GRAPHS)
def test_port_archive_restores_in_the_reference(name, tmp_path):
    _port_archive_restores_in_the_reference(name, tmp_path)
