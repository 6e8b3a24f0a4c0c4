"""Model import: TF GraphDef and ONNX -> SameDiff graphs (counterpart of
deeplearning4j_tpu/imports/__init__.py; samediff-import-tensorflow/-onnx).

Neither ``tensorflow``, ``google.protobuf`` nor ``onnx`` is needed: both
importers decode their protos with ``protomini``. ``KerasModelImport``
waits for the layers it builds (ROADMAP.md Queue 1, the Keras import entry
after item 4).
"""

from deeplearning4j_tpu_torch.imports.onnx_import import (  # noqa: F401
    OnnxImporter, import_onnx)
from deeplearning4j_tpu_torch.imports.tf_import import (  # noqa: F401
    TFGraphMapper, import_graph_def)


class KerasModelImport:
    """Not ported yet: Keras HDF5 import builds networks from 34 layer
    classes, 23 of them not in the port yet (ROADMAP.md Queue 1, the
    ``imports/keras_import.py`` entry after item 4)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "KerasModelImport is not ported yet: it waits for the Keras "
            "import entry of ROADMAP.md Queue 1 (after item 4), which needs "
            "the 23 layer classes it builds that the port lacks")

    @staticmethod
    def import_keras_model_and_weights(*args, **kwargs):
        KerasModelImport()

    @staticmethod
    def import_keras_sequential_model_and_weights(*args, **kwargs):
        KerasModelImport()
