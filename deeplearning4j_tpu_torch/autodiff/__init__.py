"""Autodiff tooling (counterpart of deeplearning4j_tpu/autodiff): the
finite-difference gradient checker."""

from deeplearning4j_tpu_torch.autodiff.gradcheck import (  # noqa: F401
    DEFAULT_EPS, DEFAULT_MAX_REL_ERROR, DEFAULT_MIN_ABS_ERROR,
    GradCheckResult, check_gradients, check_model_gradients)
