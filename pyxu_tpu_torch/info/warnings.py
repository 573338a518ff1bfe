"""Framework warning taxonomy (counterpart of ``pyxu_tpu/info/warnings.py``)."""

__all__ = [
    "PyxuTpuWarning",
    "PyxuWarning",
    "AutoInferenceWarning",
    "BackendWarning",
    "DenseWarning",
    "NonTransparentWarning",
    "PerformanceWarning",
    "PrecisionWarning",
]


class PyxuTpuWarning(UserWarning):
    """Base class for all framework warnings."""


PyxuWarning = PyxuTpuWarning


class AutoInferenceWarning(PyxuTpuWarning):
    """A quantity (adjoint/grad/Lipschitz) was auto-derived and may be loose."""


class BackendWarning(PyxuTpuWarning):
    """Requested platform/backend feature is unavailable or degraded."""


class DenseWarning(PyxuTpuWarning):
    """A structured operator is being materialized densely."""


class NonTransparentWarning(PyxuTpuWarning):
    """An operation may not be referentially transparent."""


class PerformanceWarning(PyxuTpuWarning):
    """Code path known to be slow on the device."""


class PrecisionWarning(PyxuTpuWarning):
    """Dtype/precision mismatch silently coerced."""
