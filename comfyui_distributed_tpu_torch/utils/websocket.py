"""A small RFC 6455 WebSocket on asyncio streams: the dispatch channel
between a master and a worker controller (the JAX package rides
aiohttp's; the port has no package for it).

- ``accept_key``: the ``Sec-WebSocket-Accept`` of the opening handshake.
- ``encode_frame`` / ``read_frame``: one frame, with the 7-, 16- and
  64-bit payload lengths; a client masks what it sends, a server does
  not, and each side refuses the other kind.
- :class:`WebSocket`: text messages (fragments joined), ping answered
  with pong, close answered with close, and on the server an optional
  heartbeat that pings every interval and drops a peer that does not
  answer within half of it.
- ``server_handshake`` checks an upgrade request's headers and returns
  the 101 answer's; ``connect`` opens a client connection over
  ``asyncio.open_connection``.

Binary messages, extensions and subprotocols are not used by the
control plane and are not negotiated.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import ssl
import struct
import urllib.parse
from typing import Mapping, NamedTuple, Optional

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA
CLOSE_NORMAL, CLOSE_PROTOCOL, CLOSE_TOO_BIG = 1000, 1002, 1009
MAX_MESSAGE = 50 * 1024 * 1024
MAX_HANDSHAKE_LINES = 100


class WebSocketError(Exception):
    """A handshake or frame the peer should not have sent."""


class Frame(NamedTuple):
    fin: bool
    opcode: int
    payload: bytes


class Message(NamedTuple):
    """``kind`` is ``"text"``, ``"binary"`` or ``"close"`` (then ``data``
    is the close code)."""
    kind: str
    data: object


def accept_key(key: str) -> str:
    digest = hashlib.sha1((key.strip() + GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _apply_mask(data: bytes, mask: bytes) -> bytes:
    if not data:
        return data
    n = len(data)
    stream = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big")
            ^ int.from_bytes(stream, "big")).to_bytes(n, "big")


def encode_frame(opcode: int, payload: bytes, mask: Optional[bytes] = None,
                 fin: bool = True) -> bytes:
    """One frame; ``mask`` (4 bytes) masks the payload, as a client must."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask is not None else 0
    n = len(payload)
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(bit | 127)
        head += struct.pack(">Q", n)
    if mask is None:
        return bytes(head) + payload
    return bytes(head) + mask + _apply_mask(payload, mask)


async def read_frame(reader: asyncio.StreamReader, expect_masked: bool,
                     max_size: int = MAX_MESSAGE) -> Frame:
    """One frame off the stream, unmasked. ``expect_masked``: the peer is
    a client (its frames must be masked) or a server (they must not)."""
    b0, b1 = await reader.readexactly(2)
    if b0 & 0x70:
        raise WebSocketError("reserved bits set (no extension was agreed)")
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    masked, n = bool(b1 & 0x80), b1 & 0x7F
    if masked != expect_masked:
        raise WebSocketError("a client must mask its frames and a server "
                             "must not")
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    if opcode >= OP_CLOSE and (n > 125 or not fin):
        raise WebSocketError("a control frame must be whole and at most "
                             "125 bytes")
    if opcode not in (OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG):
        raise WebSocketError(f"unknown opcode {opcode:#x}")
    if n > max_size:
        raise WebSocketError(f"frame of {n} bytes over the limit {max_size}")
    mask = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n) if n else b""
    if mask is not None:
        payload = _apply_mask(payload, mask)
    return Frame(fin, opcode, payload)


def server_handshake(headers: Mapping[str, str]) -> dict[str, str]:
    """The 101 answer's headers for an upgrade request (header names in
    lower case); raises ``WebSocketError`` when it is not one."""
    if headers.get("upgrade", "").lower() != "websocket":
        raise WebSocketError("not a WebSocket upgrade (Upgrade: websocket)")
    if "upgrade" not in headers.get("connection", "").lower():
        raise WebSocketError("not a WebSocket upgrade (Connection: Upgrade)")
    if headers.get("sec-websocket-version") != "13":
        raise WebSocketError("Sec-WebSocket-Version must be 13")
    key = headers.get("sec-websocket-key", "")
    try:
        if len(base64.b64decode(key, validate=True)) != 16:
            raise ValueError
    except ValueError:
        raise WebSocketError("bad Sec-WebSocket-Key") from None
    return {"Upgrade": "websocket", "Connection": "Upgrade",
            "Sec-WebSocket-Accept": accept_key(key)}


class WebSocket:
    """One open connection. ``client``: this end masks its frames.
    ``heartbeat`` (seconds, server side): ping every interval and drop a
    peer whose pong does not come within half of it."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, client: bool,
                 heartbeat: Optional[float] = None,
                 max_size: int = MAX_MESSAGE):
        self._reader, self._writer = reader, writer
        self._client = client
        self._max_size = max_size
        self._send_lock = asyncio.Lock()
        self._pong = asyncio.Event()
        self.closed = False
        self.close_code: Optional[int] = None
        self._heartbeat = (asyncio.ensure_future(self._beat(heartbeat))
                           if heartbeat else None)

    async def _send(self, opcode: int, payload: bytes) -> None:
        mask = os.urandom(4) if self._client else None
        async with self._send_lock:
            self._writer.write(encode_frame(opcode, payload, mask))
            await self._writer.drain()

    async def send_str(self, text: str) -> None:
        if self.closed:
            raise ConnectionResetError("WebSocket is closed")
        await self._send(OP_TEXT, text.encode("utf-8"))

    async def ping(self, payload: bytes = b"") -> None:
        await self._send(OP_PING, payload)

    async def receive(self, timeout: Optional[float] = None) -> Message:
        """The next text or binary message, or ``close`` once the peer
        closed (or broke the protocol, or the heartbeat dropped it)."""
        return await asyncio.wait_for(self._receive(), timeout)

    async def _receive(self) -> Message:
        if self.closed:
            return Message("close", self.close_code)
        parts: list[bytes] = []
        kind = None
        try:
            while True:
                frame = await read_frame(self._reader, not self._client,
                                         self._max_size)
                if frame.opcode == OP_PING:
                    await self._send(OP_PONG, frame.payload)
                elif frame.opcode == OP_PONG:
                    self._pong.set()
                elif frame.opcode == OP_CLOSE:
                    code = (struct.unpack(">H", frame.payload[:2])[0]
                            if len(frame.payload) >= 2 else CLOSE_NORMAL)
                    await self._finish(code)
                    return Message("close", code)
                else:
                    if (frame.opcode == OP_CONT) != (kind is not None):
                        raise WebSocketError("fragments out of order")
                    kind = kind or ("text" if frame.opcode == OP_TEXT
                                    else "binary")
                    parts.append(frame.payload)
                    if sum(map(len, parts)) > self._max_size:
                        await self._finish(CLOSE_TOO_BIG)
                        return Message("close", CLOSE_TOO_BIG)
                    if frame.fin:
                        data = b"".join(parts)
                        return Message(kind, data.decode("utf-8")
                                       if kind == "text" else data)
        except WebSocketError:
            await self._finish(CLOSE_PROTOCOL)
            return Message("close", CLOSE_PROTOCOL)
        except (asyncio.IncompleteReadError, ConnectionError, UnicodeDecodeError):
            self._drop()
            return Message("close", self.close_code)

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        msg = await self.receive()
        if msg.kind == "close":
            raise StopAsyncIteration
        return msg

    async def close(self, code: int = CLOSE_NORMAL) -> None:
        """Send close and wait briefly for the peer's; then drop the
        stream."""
        if self.closed:
            return
        try:
            await self._send(OP_CLOSE, struct.pack(">H", code))
            self.closed, self.close_code = True, code
            while True:
                frame = await asyncio.wait_for(
                    read_frame(self._reader, not self._client, self._max_size),
                    1.0)
                if frame.opcode == OP_CLOSE:
                    break
        except (WebSocketError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, ConnectionError):
            pass
        self._drop()

    async def _finish(self, code: int) -> None:
        """Answer the peer's close (or end on a protocol error)."""
        if not self.closed:
            try:
                await self._send(OP_CLOSE, struct.pack(">H", code))
            except ConnectionError:
                pass
        self.closed, self.close_code = True, code
        self._drop()

    def _drop(self) -> None:
        self.closed = True
        if self._heartbeat is not None and \
                self._heartbeat is not asyncio.current_task():
            self._heartbeat.cancel()
        self._writer.close()

    async def _beat(self, interval: float) -> None:
        try:
            while not self.closed:
                await asyncio.sleep(interval)
                self._pong.clear()
                await self.ping()
                try:
                    await asyncio.wait_for(self._pong.wait(), interval / 2)
                except asyncio.TimeoutError:
                    self._drop()
                    return
        except ConnectionError:
            self._drop()


async def connect(url: str, headers: Optional[Mapping[str, str]] = None,
                  timeout: float = 30.0) -> WebSocket:
    """Open a client connection to ``url`` (``http(s)://`` or
    ``ws(s)://``). Raises ``OSError``, ``asyncio.TimeoutError`` or
    ``WebSocketError`` (an answer other than a valid 101) while it
    opens; nothing has been delivered then."""
    parts = urllib.parse.urlsplit(url)
    secure = parts.scheme in ("https", "wss")
    port = parts.port or (443 if secure else 80)
    reader, writer = await asyncio.wait_for(asyncio.open_connection(
        parts.hostname, port,
        ssl=ssl.create_default_context() if secure else None), timeout)
    try:
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        target = parts.path or "/"
        if parts.query:
            target += "?" + parts.query
        lines = [f"GET {target} HTTP/1.1", f"Host: {parts.netloc}",
                 "Upgrade: websocket", "Connection: Upgrade",
                 f"Sec-WebSocket-Key: {key}", "Sec-WebSocket-Version: 13"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()

        async def answer() -> tuple[str, dict[str, str]]:
            status = (await reader.readline()).decode("latin-1").strip()
            got: dict[str, str] = {}
            for _ in range(MAX_HANDSHAKE_LINES):
                line = (await reader.readline()).decode("latin-1").strip()
                if not line:
                    return status, got
                name, _, value = line.partition(":")
                got[name.strip().lower()] = value.strip()
            raise WebSocketError("handshake answer has too many headers")

        status, got = await asyncio.wait_for(answer(), timeout)
        if status.split(" ")[1:2] != ["101"]:
            raise WebSocketError(f"handshake refused: {status!r}")
        if got.get("sec-websocket-accept") != accept_key(key):
            raise WebSocketError("bad Sec-WebSocket-Accept")
    except BaseException:
        writer.close()
        raise
    return WebSocket(reader, writer, client=True)
