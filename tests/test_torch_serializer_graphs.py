"""ModelSerializer archives between the packages for two
ComputationGraphs, on the CPU: a small residual graph (conv, batchnorm, an
add vertex) and the masked Bidirectional(LSTM) graph, each written by one
package and restored by the other, with the checks and tolerances of
``test_torch_serializer.py`` (whose helpers run them)."""

import pytest

pytest.importorskip("torch")

from test_torch_serializer import (  # noqa: E402
    _port_archive_restores_in_the_reference,
    _reference_archive_restores_in_the_port)

GRAPHS = ["resnet_graph", "bidir_graph"]


@pytest.mark.parametrize("name", GRAPHS)
def test_reference_archive_restores_in_the_port(name, tmp_path):
    _reference_archive_restores_in_the_port(name, tmp_path)


@pytest.mark.parametrize("name", GRAPHS)
def test_port_archive_restores_in_the_reference(name, tmp_path):
    _port_archive_restores_in_the_reference(name, tmp_path)
