"""Model import (counterpart of deeplearning4j_tpu/imports/__init__.py):
TF GraphDef and ONNX -> SameDiff graphs (samediff-import-tensorflow/-onnx),
Keras HDF5 and ``.keras`` files -> networks (deeplearning4j-modelimport).

Neither ``tensorflow``, ``google.protobuf``, ``onnx`` nor ``h5py`` is
needed: the graph importers decode their protos with ``protomini``, the
Keras importer reads HDF5 with ``h5mini``.
"""

from deeplearning4j_tpu_torch.imports.onnx_import import (  # noqa: F401
    OnnxImporter, import_onnx)
from deeplearning4j_tpu_torch.imports.tf_import import (  # noqa: F401
    TFGraphMapper, import_graph_def)
from deeplearning4j_tpu_torch.imports.keras_import import (  # noqa: F401
    KerasImportError, KerasModelImport)
