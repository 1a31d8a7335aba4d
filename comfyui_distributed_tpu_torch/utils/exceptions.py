"""Typed errors of the port (the part of the JAX package's
``utils/exceptions.py`` it raises; the port imports nothing from that
package).
"""

from __future__ import annotations


class DistributedError(Exception):
    """Base class for all framework errors."""


class ConfigError(DistributedError):
    """Invalid or unwritable configuration."""


class WorkerError(DistributedError):
    """A worker host misbehaved or could not be reached."""

    def __init__(self, message: str, worker_id: str | None = None):
        super().__init__(message)
        self.worker_id = worker_id


class JobQueueError(DistributedError):
    """Job store misuse: a result for a job that never existed."""

    def __init__(self, message: str, job_id: str | None = None):
        super().__init__(message)
        self.job_id = job_id


class TileCollectionError(DistributedError):
    """Tile/shard result collection failed or timed out."""


class ValidationError(DistributedError):
    """Request/prompt payload failed validation (reference api/schemas.py)."""

    def __init__(self, message: str, field: str | None = None):
        super().__init__(message)
        self.field = field


class ProcessError(DistributedError):
    """A managed worker process could not be launched or stopped."""


class TunnelError(DistributedError):
    """The cloudflared tunnel could not be started."""


class ShardingError(DistributedError):
    """A mesh shape that the devices cannot take, or a missing axis."""


class MeshError(DistributedError):
    """A call over the device mesh failed on one of its ranks (the rank is
    named); the mesh's followers are torn down and restart at its next
    use."""

    def __init__(self, message: str, rank: int | None = None):
        super().__init__(message)
        self.rank = rank
