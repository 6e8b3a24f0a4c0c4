"""The serving tier's load and reload errors (the port's copies of
deeplearning4j_tpu/serving/resilience.py:145-152). The reference module's
breakers, brownout and fleet supervision are later serving slices."""


class ModelLoadError(RuntimeError):
    """An archive failed to load cleanly (corrupt or truncated zip, or a
    structure that does not match its own configuration).
    ``ModelRouter.load`` raises it without registering anything;
    ``reload`` raises it with the old version still serving. ``__cause__``
    carries the underlying error."""


class ReloadRejectedError(RuntimeError):
    """A rolling reload was rejected before the swap (canary failure,
    warmup failure or a parameter-structure mismatch); the old weights
    keep serving."""
