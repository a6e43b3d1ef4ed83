"""Cooperative cancellation: StopSource/StopToken (counterpart of
arrow1_tpu/cancel.py).

Reference: cpp/src/arrow/util/cancel.h:37,57 — a StopSource owns the flag,
readers poll StopToken between units of work.
"""

from __future__ import annotations

import threading
from typing import Optional

from .errors import A1TError

__all__ = ["StopSource", "StopToken", "CancelledError"]


class CancelledError(A1TError):
    """Reference: Status::Cancelled."""


class StopToken:
    """Poll side (reference: cancel.h:57)."""

    def __init__(self, source: "StopSource"):
        self._source = source

    def is_stop_requested(self) -> bool:
        return self._source._stopped.is_set()

    def poll(self) -> None:
        """Raise if a stop was requested (reference: StopToken::Poll)."""
        if self.is_stop_requested():
            raise CancelledError(self._source._reason or "operation cancelled")


class StopSource:
    """Owner side (reference: cancel.h:37)."""

    def __init__(self):
        self._stopped = threading.Event()
        self._reason: Optional[str] = None

    def request_stop(self, reason: Optional[str] = None) -> None:
        self._reason = reason
        self._stopped.set()

    def token(self) -> StopToken:
        return StopToken(self)

    def reset(self) -> None:
        self._stopped.clear()
        self._reason = None
