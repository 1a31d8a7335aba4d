"""multipart/form-data on the standard library: build a body by hand,
split one by its boundary. Carries the collector's frames
(``/distributed/job_complete_frames``)."""

from __future__ import annotations

import dataclasses
import re
import secrets

from .exceptions import ValidationError

_PARAM = re.compile(r';\s*([\w-]+)="?([^";]*)"?')


@dataclasses.dataclass(frozen=True)
class Part:
    name: str
    data: bytes
    filename: str = ""
    content_type: str = "application/octet-stream"


def build_multipart(parts: list[Part]) -> tuple[bytes, str]:
    """→ (body, Content-Type header value)."""
    boundary = f"cdt-{secrets.token_hex(16)}"
    chunks = []
    for p in parts:
        disposition = f'form-data; name="{p.name}"'
        if p.filename:
            disposition += f'; filename="{p.filename}"'
        chunks.append(
            f"--{boundary}\r\nContent-Disposition: {disposition}\r\n"
            f"Content-Type: {p.content_type}\r\n\r\n".encode()
            + p.data + b"\r\n")
    chunks.append(f"--{boundary}--\r\n".encode())
    return b"".join(chunks), f"multipart/form-data; boundary={boundary}"


def parse_multipart(body: bytes, content_type: str) -> list[Part]:
    """Split a multipart/form-data body into its parts."""
    params = dict(_PARAM.findall(content_type))
    boundary = params.get("boundary")
    if not content_type.lower().startswith("multipart/form-data") or not boundary:
        raise ValidationError("expected multipart/form-data with a boundary")
    segments = body.split(b"--" + boundary.encode())
    if len(segments) < 2 or not segments[-1].startswith(b"--"):
        raise ValidationError("multipart body is not closed by its boundary")
    parts = []
    for seg in segments[1:-1]:
        head, sep, data = seg.partition(b"\r\n\r\n")
        if not sep or not head.startswith(b"\r\n") or not data.endswith(b"\r\n"):
            raise ValidationError("malformed multipart part")
        headers = {}
        for line in head[2:].decode("utf-8", "replace").split("\r\n"):
            key, _, value = line.partition(":")
            headers[key.strip().lower()] = value.strip()
        disposition = dict(_PARAM.findall(headers.get("content-disposition", "")))
        parts.append(Part(disposition.get("name", ""), data[:-2],
                          disposition.get("filename", ""),
                          headers.get("content-type", "text/plain")))
    return parts
