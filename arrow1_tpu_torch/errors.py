"""Error model (counterpart of arrow1_tpu/errors.py).

Kernels cannot raise; checked kernels compute error flags that the eager
entry point reduces on the host and raises from.
"""


class A1TError(Exception):
    """Base engine error (Status umbrella)."""


class Invalid(A1TError, ValueError):
    """Bad arguments or runtime domain errors (Status::Invalid)."""


class NotImplementedError_(A1TError, NotImplementedError):
    """A type or operation that a later slice of the port brings."""


class IndexError_(A1TError, IndexError):
    """Out-of-bounds take index (Status::IndexError)."""


class KeyError_(A1TError, KeyError):
    """Registry or column lookup failure (Status::KeyError)."""
