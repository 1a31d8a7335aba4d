"""Typed errors of the port (the part of the JAX package's
``utils/exceptions.py`` it raises; the port imports nothing from that
package).
"""

from __future__ import annotations


class DistributedError(Exception):
    """Base class for all framework errors."""


class ValidationError(DistributedError):
    """Request/prompt payload failed validation (reference api/schemas.py)."""

    def __init__(self, message: str, field: str | None = None):
        super().__init__(message)
        self.field = field
