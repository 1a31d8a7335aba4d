"""Optional shared-secret auth for the control plane (the port's copy of
the JAX package's ``utils/auth.py``).

One cluster-wide token (``CDT_AUTH_TOKEN``, or ``settings.auth_token`` in
the cluster config) gates every mutating route: a request must carry it
in the ``X-CDT-Auth`` header (or ``Authorization: Bearer``). Probe and
status reads stay open, so liveness checks and progress polling keep
working. With no token configured everything stays open. Cluster peers
attach the token to every outbound call (``utils/network.py``).

One departure from the JAX package: the worker's dispatch WebSocket
(``GET /distributed/worker_ws``) is gated too. It enqueues prompts, and
the JAX package leaves it open because its opening request is a GET.
"""

from __future__ import annotations

import hmac
import secrets
from typing import Any, Mapping, Optional

AUTH_HEADER = "X-CDT-Auth"
AUTH_ENV = "CDT_AUTH_TOKEN"      # knob: constants.auth_token


def configured_token(cfg: Optional[dict[str, Any]] = None) -> Optional[str]:
    """The cluster token, if any: the environment wins over the config's
    ``settings.auth_token``."""
    from .constants import auth_token

    env = auth_token()
    if env:
        return env
    tok = (cfg or {}).get("settings", {}).get("auth_token")
    return str(tok) if tok else None


def generate_token() -> str:
    return secrets.token_urlsafe(24)


def resolve_token(config_path=None) -> Optional[str]:
    """Hot-path lookup: the environment, else one settings key of the
    config (``config.peek_setting``: one stat when its cache is warm)."""
    from .config import peek_setting
    from .constants import auth_token

    env = auth_token()
    if env:
        return env
    tok = peek_setting("auth_token", None, config_path)
    return str(tok) if tok else None


def token_matches(request_headers: Mapping[str, str], token: str) -> bool:
    """Constant-time check of ``X-CDT-Auth`` / ``Authorization: Bearer``
    (header names in any case). Compares bytes: ``compare_digest`` raises
    on non-ASCII strings, and a malformed header must read as 401, not
    500."""
    headers = {k.lower(): v for k, v in request_headers.items()}
    presented = headers.get(AUTH_HEADER.lower(), "")
    if not presented:
        bearer = headers.get("authorization", "")
        if bearer.startswith("Bearer "):
            presented = bearer[len("Bearer "):]
    if not presented:
        return False
    return hmac.compare_digest(
        presented.encode("utf-8", "surrogateescape"),
        token.encode("utf-8", "surrogateescape"))


# Reads that are gated when a token is set: the config holds the token
# itself, the log surfaces can carry secrets, the dispatch WebSocket
# opens with a GET but enqueues prompts, and a fleet-cache entry is a
# user's result.
_GATED_READ_PREFIXES = (
    "/distributed/config",
    "/distributed/local_log",
    "/distributed/worker_log/",
    "/distributed/remote_worker_log/",
    "/distributed/worker_ws",
    "/distributed/cache/entry/",
)


def requires_auth(method: str, path: str) -> bool:
    """Every mutating (non-GET/HEAD/OPTIONS) route needs the token; reads
    stay open except the gated ones above."""
    if any(path == p or path.startswith(p) for p in _GATED_READ_PREFIXES):
        return True
    return method not in ("GET", "HEAD", "OPTIONS")
