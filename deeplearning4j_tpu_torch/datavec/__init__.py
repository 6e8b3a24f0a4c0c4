"""DataVec-parity ETL (SURVEY.md §2.2 J12); the port's copy of
deeplearning4j_tpu/datavec (records, transforms, executors, iterators), pure
host Python that imports nothing of the JAX package.

Reference: the `datavec/` module family — RecordReader zoo
(org/datavec/api/records/reader/impl/**), schema-typed TransformProcess
(org/datavec/api/transform/TransformProcess.java), image loading
(datavec-data-image NativeImageLoader via JavaCPP OpenCV) — path-cites, mount
empty this round.

TPU-native stance: ETL is host-side work feeding the device input pipeline;
records are plain Python lists / numpy arrays (no Writable object hierarchy —
that existed for JVM serialization), transforms are pure functions over
columns, and the iterator layer batches straight into numpy, which
``data/prefetch.py`` stages on the card.
"""

from deeplearning4j_tpu_torch.datavec.records import (  # noqa: F401
    CollectionRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    LineRecordReader,
    RecordReader,
    RegexLineRecordReader,
    SVMLightRecordReader,
    TfidfRecordReader,
    TransformProcessRecordReader,
    WavFileRecordReader,
    ArrowRecordReader,
    write_arrow,
)
from deeplearning4j_tpu_torch.datavec.transform import (  # noqa: F401
    ColumnType,
    Join,
    Reducer,
    Schema,
    TransformProcess,
)
from deeplearning4j_tpu_torch.datavec.iterators import (  # noqa: F401
    RecordReaderDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)
from deeplearning4j_tpu_torch.datavec.executor import (  # noqa: F401
    LocalTransformExecutor,
    MultiProcessTransformExecutor,
    ParallelTransformRecordReader,
    TransformExecutionError,
)
