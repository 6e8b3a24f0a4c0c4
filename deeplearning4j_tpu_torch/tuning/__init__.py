"""Autotuning (counterpart of deeplearning4j_tpu/tuning): searchable knob
spaces, an equivalence-gated measurement driver, and a persistent tuning
database consulted by ``auto`` kernel dispatch.

- ``tuning/space.py``: the search-space registry (``conv2d_tiles``: the
  conv kernel's row tiles, K2; ``lstm_tiles``: the LSTM segment kernel or
  the plain loop; ``bucket_sets``; ``prefill_chunk``; ``affinity_head``).
- ``tuning/measure.py``: the measurement driver (grid or seeded random
  search with greedy refinement, two-point-fit median-of-N timing with
  each window closed by a device sync, and the equivalence gate).
- ``tuning/database.py``: the persistent database, the reference's schema,
  keyed by backend ``cuda:sm_90`` on an H100; armed by
  ``DL4J_TPU_TUNING_DB`` or :func:`set_database`.
"""

from deeplearning4j_tpu_torch.tuning.database import (  # noqa: F401
    TuningDatabase, TuningKey, candidates_digest, conf_default,
    current_status, database_dir, get_database, resolve, set_database)
from deeplearning4j_tpu_torch.tuning.measure import (  # noqa: F401
    MeasurementDriver)
from deeplearning4j_tpu_torch.tuning.space import (  # noqa: F401
    AffinityHeadSpace, BucketSetSpace, Candidate, ConvTileSpace,
    LstmTileSpace, MeasureCase, PrefillChunkSpace, SearchSpace, get_space,
    measurable_spaces, register_space, space_names)
