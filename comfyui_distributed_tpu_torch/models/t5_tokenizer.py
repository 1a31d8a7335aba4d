"""T5's tokenizer, read from the ``tokenizer.json`` every T5 distribution
ships (counterpart of the JAX ``models/t5.py`` ``load_t5_tokenizer``,
which is ``transformers.AutoTokenizer``; the port imports neither
``transformers`` nor ``tokenizers`` nor ``sentencepiece``).

The pipeline is the one HF ``tokenizers`` runs for that file:

1. added tokens (``<pad>``, ``</s>``, ``<unk>``, ``<extra_id_N>``) are
   cut out of the raw text, leftmost-longest, and keep their ids;
2. each piece between them is normalised: ``Precompiled`` (the
   SentencePiece character map) then ``Replace(" {2,}", " ")``, in a
   ``Sequence`` or alone;
3. pre-tokenised: ``Metaspace("▁")`` in either published form
   (``add_prefix_space: true``, or ``prepend_scheme`` ``always``/
   ``first``/``never`` with ``split``), alone or after
   ``WhitespaceSplit``;
4. each word is split by the ``Unigram`` model: Viterbi over the pieces
   it starts with (ties keep the shorter piece), a character no piece
   covers becomes ``<unk>`` at the lowest score less 10, and adjacent
   unknowns fuse into one;
5. the ``TemplateProcessing`` template (``$A </s>``) appends ``</s>``;
   ``encode`` truncates the words' ids so that the template still fits
   ``max_len`` (``</s>`` is kept) and pads with the pad id 0 and a 0 mask.

``Precompiled`` parses the charsmap blob: a little-endian uint32 trie
size, a darts-clone double array of uint32 units, then the
NUL-terminated normalised strings. HF normalises grapheme by grapheme: a
grapheme under 6 bytes with a match in the trie is replaced whole by its
first (shortest) match, anything else character by character. The port
has no grapheme segmentation of its own (the standard library has
none): its clusters are a character and the extending characters after
it (marks, ZWJ/ZWNJ, emoji modifiers and tags, the halfwidth sound
marks, Thai and Lao AM), and ``\\r\\n``. It differs from HF only where a
Prepend character (U+0600-U+0605, U+06DD, U+070F, U+08E2, ...) begins a
cluster: HF replaces ``"\\u0600a"`` whole when U+0600 has a mapping, the
port maps U+0600 and keeps ``a`` (``tests/test_torch_t5_tokenizer.py``
holds both). ``encode_charsmap`` writes such a blob from a mapping (the
tests and ``chip_smoke.py`` build synthetic tokenizers with it).

A normalizer, pre-tokenizer, model or post-processor type outside this
list raises ``ValueError`` naming it.
"""

from __future__ import annotations

import base64
import json
import re
import struct
import unicodedata
from pathlib import Path
from typing import Mapping, Optional, Sequence, Union

METASPACE = "▁"
K_UNK_PENALTY = 10.0
_END = ""                 # the piece trie's end-of-piece key (chars are 1 long)
_MAX_GRAPHEME_BYTES = 6   # HF tries a grapheme whole below this many bytes
# Unicode White_Space (Rust's ``char::is_whitespace``, HF's WhitespaceSplit)
_WS = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f"
       "\u205f\u3000")
_WORD = re.compile(f"[^{_WS}]+")
_EXTENDING = frozenset((0x200C, 0x200D, 0xFF9E, 0xFF9F, 0x0E33, 0x0EB3))


def _extends(ch: str) -> bool:
    """Whether ``ch`` continues the cluster before it."""
    cp = ord(ch)
    return (unicodedata.category(ch)[0] == "M" or cp in _EXTENDING
            or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F)


def clusters(text: str) -> list[str]:
    """``text`` cut into a character and the characters extending it."""
    out: list[str] = []
    for ch in text:
        if out and (_extends(ch) or (ch == "\n" and out[-1] == "\r")):
            out[-1] += ch
        else:
            out.append(ch)
    return out


# ---------------------------------------------------------------------------
# Precompiled: SentencePiece's character map (darts-clone double array)
# ---------------------------------------------------------------------------

class Precompiled:
    """The ``Precompiled`` normalizer over a charsmap blob."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled charsmap: shorter than its header")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if trie_size % 4 or 4 + trie_size > len(blob):
            raise ValueError(f"precompiled charsmap: trie size {trie_size} "
                             f"does not fit {len(blob)} bytes")
        self.units = struct.unpack_from(f"<{trie_size // 4}I", blob, 4)
        self.normalized = blob[4 + trie_size:]

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of the first (shortest) key that prefixes
        ``chunk``, or None."""
        units = self.units
        pos = self._offset(units[0])
        for byte in chunk.encode("utf-8"):
            if byte == 0:
                return None
            pos ^= byte
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != byte:
                return None
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                start = units[pos] & ((1 << 31) - 1)
                end = self.normalized.index(b"\0", start)
                return self.normalized[start:end].decode("utf-8")
        return None

    def __call__(self, text: str) -> str:
        out = []
        for cluster in clusters(text):
            if len(cluster.encode("utf-8")) < _MAX_GRAPHEME_BYTES:
                norm = self.transform(cluster)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in cluster:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


def encode_charsmap(mapping: Mapping[str, str]) -> bytes:
    """A charsmap blob that ``Precompiled`` (the port's and HF's) reads as
    ``mapping`` (key → replacement): the keys' UTF-8 bytes in a
    double-array trie, each node at a base of its own, children at
    ``base ^ byte``, the end-of-key leaf at ``base``, the array padded to
    whole blocks of 256 units."""
    strings = bytearray()
    trie: dict = {}
    for key in sorted(mapping):
        if not key or "\0" in key or "\0" in mapping[key]:
            raise ValueError(f"charsmap key {key!r}: empty or holds NUL")
        node = trie
        for byte in key.encode("utf-8"):
            node = node.setdefault(byte, {})
        node[-1] = len(strings)
        strings += mapping[key].encode("utf-8") + b"\0"
    units = [0]
    used_bases: set[int] = set()

    def free(pos: int) -> bool:
        return pos != 0 and (pos >= len(units) or units[pos] == 0)

    queue = [(0, trie)]
    while queue:
        pos, node = queue.pop(0)
        labels = sorted(0 if k == -1 else k for k in node)
        base = 1
        while (base in used_bases or base == pos
               or not all(free(base ^ c) for c in labels)):
            base += 1
        used_bases.add(base)
        need = max(base ^ c for c in labels) + 1
        units.extend([0] * (need - len(units)))
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("charsmap too large for unextended offsets")
        units[pos] |= (offset << 10) | ((-1 in node) << 8)
        for byte, child in node.items():
            if byte == -1:
                units[base] = (1 << 31) | child
            else:
                units[base ^ byte] = byte
                queue.append((base ^ byte, child))
    # whole 256-unit blocks: a lookup XORs any byte into a base, and HF's
    # reader does not bound-check the position it lands on
    units.extend([0] * ((max(used_bases) | 0xFF) + 1 - len(units)))
    trie_blob = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie_blob)) + trie_blob + bytes(strings)


# ---------------------------------------------------------------------------
# the Unigram model
# ---------------------------------------------------------------------------

class Unigram:
    """HF ``tokenizers``' Unigram encoder: best-scoring segmentation of a
    word into pieces (``vocab``: [piece, score] in id order)."""

    def __init__(self, vocab: Sequence, unk_id: Optional[int],
                 byte_fallback: bool = False):
        if byte_fallback:
            raise ValueError("Unigram byte_fallback is not read")
        if unk_id is None:
            raise ValueError("Unigram without an unk_id is not read")
        self.pieces = [str(p) for p, _ in vocab]
        self.scores = [float(s) for _, s in vocab]
        self.unk_id = int(unk_id)
        self.ids = {p: i for i, p in enumerate(self.pieces)}
        self.unk_score = min(self.scores) - K_UNK_PENALTY
        self.trie: dict = {}
        for piece in self.ids:
            node = self.trie
            for ch in piece:
                node = node.setdefault(ch, {})
            node[_END] = self.ids[piece]

    def split(self, word: str) -> list[str]:
        n = len(word)
        score = [0.0] * (n + 1)
        start: list[Optional[int]] = [None] * (n + 1)
        ids = [0] * (n + 1)

        def offer(end: int, begin: int, cand: float, pid: int) -> None:
            if start[end] is None or cand > score[end]:
                score[end], start[end], ids[end] = cand, begin, pid

        for i in range(n):
            base, single, node = score[i], False, self.trie
            for j in range(i, n):
                node = node.get(word[j])
                if node is None:
                    break
                pid = node.get(_END)
                if pid is not None:
                    offer(j + 1, i, self.scores[pid] + base, pid)
                    single = single or j == i
            if not single:
                offer(i + 1, i, self.unk_score + base, self.unk_id)
        out: list[str] = []
        unknown: list[str] = []
        end = n
        while end > 0:
            begin = start[end]
            if ids[end] == self.unk_id:
                unknown.append(word[begin:end])
            else:
                if unknown:
                    out.append("".join(reversed(unknown)))
                    unknown = []
                out.append(word[begin:end])
            end = begin
        if unknown:
            out.append("".join(reversed(unknown)))
        return out[::-1]

    def tokenize(self, word: str) -> list[int]:
        return [self.ids.get(p, self.unk_id) for p in self.split(word)]


# ---------------------------------------------------------------------------
# tokenizer.json
# ---------------------------------------------------------------------------

def _normalizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def run(s: str) -> str:
            for part in parts:
                s = part(s)
            return s
        return run
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap")
        if not blob:
            return lambda s: s
        return Precompiled(base64.b64decode(blob))
    if kind == "Replace":
        pattern = spec["pattern"]
        if "Regex" in pattern:
            rx = re.compile(pattern["Regex"])
        else:
            rx = re.compile(re.escape(pattern["String"]))
        content = spec["content"]
        return lambda s: rx.sub(lambda _: content, s)
    raise ValueError(f"T5 tokenizer.json: normalizer type {kind!r} is not "
                     "read (have Sequence, Precompiled, Replace)")


class _Metaspace:
    def __init__(self, spec: dict):
        self.rep = spec.get("replacement", METASPACE)
        if "prepend_scheme" in spec:
            self.scheme = spec["prepend_scheme"]
        else:
            self.scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if self.scheme not in ("always", "first", "never"):
            raise ValueError(f"T5 tokenizer.json: Metaspace prepend_scheme "
                             f"{self.scheme!r} is not read")
        self.split = bool(spec.get("split", True))

    def __call__(self, pieces: list[tuple[str, bool]]) -> list[tuple[str, bool]]:
        out = []
        for text, at_start in pieces:
            text = text.replace(" ", self.rep)
            if text and not text.startswith(self.rep) and (
                    self.scheme == "always"
                    or (self.scheme == "first" and at_start)):
                text = self.rep + text
            if not self.split:
                out.append((text, at_start))
                continue
            # each replacement character begins a new word
            cuts = [i for i, ch in enumerate(text) if ch == self.rep and i]
            for a, b in zip([0] + cuts, cuts + [len(text)]):
                if b > a:
                    out.append((text[a:b], at_start and a == 0))
        return out


def _whitespace_split(pieces: list[tuple[str, bool]]) -> list[tuple[str, bool]]:
    out = []
    for text, at_start in pieces:
        for m in _WORD.finditer(text):
            out.append((m.group(), at_start and m.start() == 0))
    return out


def _pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(pieces):
            for part in parts:
                pieces = part(pieces)
            return pieces
        return run
    if kind == "Metaspace":
        return _Metaspace(spec)
    if kind == "WhitespaceSplit":
        return _whitespace_split
    raise ValueError(f"T5 tokenizer.json: pre-tokenizer type {kind!r} is not "
                     "read (have Sequence, Metaspace, WhitespaceSplit)")


def _template(spec: Optional[dict]) -> tuple[list, list]:
    """The single-sequence template as (ids before, ids after) ``$A``."""
    if spec is None:
        return [], []
    if spec.get("type") != "TemplateProcessing":
        raise ValueError(f"T5 tokenizer.json: post-processor type "
                         f"{spec.get('type')!r} is not read (have "
                         "TemplateProcessing)")
    before: list[int] = []
    after: list[int] = []
    seen_a = False
    for item in spec["single"]:
        if "Sequence" in item:
            if item["Sequence"]["id"] != "A":
                raise ValueError("T5 tokenizer.json: a single template over "
                                 f"{item['Sequence']['id']!r}")
            seen_a = True
        elif "SpecialToken" in item:
            ids = spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]
            (after if seen_a else before).extend(int(i) for i in ids)
    return before, after


class T5Tokenizer:
    """A T5 ``tokenizer.json``: ``encode`` → (ids, mask), each padded to
    ``max_len``."""

    def __init__(self, spec: Mapping):
        model = spec.get("model") or {}
        if model.get("type") != "Unigram":
            raise ValueError(f"T5 tokenizer.json: model type "
                             f"{model.get('type')!r} is not read (have "
                             "Unigram)")
        self.model = Unigram(model["vocab"], model.get("unk_id"),
                             bool(model.get("byte_fallback", False)))
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.before, self.after = _template(spec.get("post_processor"))
        added = sorted(spec.get("added_tokens") or [],
                       key=lambda t: -len(t["content"]))
        self.added = {t["content"]: int(t["id"]) for t in added}
        self._added_rx = (re.compile("|".join(
            (r"\s*" if t.get("lstrip") else "") + re.escape(t["content"])
            + (r"\s*" if t.get("rstrip") else "") for t in added))
            if added else None)
        self.pad_id = self.added.get("<pad>", self.model.ids.get("<pad>", 0))

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "T5Tokenizer":
        return cls(json.loads(Path(path).read_text(encoding="utf-8")))

    def _segment_ids(self, text: str, at_start: bool) -> list[int]:
        words = self.pre_tokenize([(self.normalize(text), at_start)])
        return [i for word, _ in words for i in self.model.tokenize(word)]

    def tokenize(self, text: str) -> list[int]:
        """Ids of ``text`` without the template, padding or truncation."""
        ids: list[int] = []
        pos = 0
        matches = (self._added_rx.finditer(text)
                   if self._added_rx is not None else ())
        for m in matches:
            if m.start() > pos:
                ids += self._segment_ids(text[pos:m.start()], pos == 0)
            ids.append(self.added[m.group().strip()])
            pos = m.end()
        if pos < len(text):
            ids += self._segment_ids(text[pos:], pos == 0)
        return ids

    def encode(self, text: str, max_len: int) -> tuple[list[int], list[int]]:
        """(ids, mask) of ``text``: truncated so that the template fits,
        the template applied, padded to ``max_len``."""
        keep = max(0, max_len - len(self.before) - len(self.after))
        ids = (self.before + self.tokenize(text)[:keep] + self.after)[:max_len]
        pad = max_len - len(ids)
        return ids + [self.pad_id] * pad, [1] * len(ids) + [0] * pad


def load_t5_tokenizer(tok_dir: Union[str, Path, None] = None
                      ) -> Optional[T5Tokenizer]:
    """The ``tokenizer.json`` under ``tok_dir`` (default
    ``CDT_T5_TOKENIZER_DIR``), or None where none is set or the directory
    holds no ``tokenizer.json`` (a warning says so; the callers then
    hash-tokenise). A file the reader cannot read raises."""
    from ..utils import constants
    from ..utils.logging import log

    tok_dir = tok_dir or constants.t5_tokenizer_dir()
    if not tok_dir:
        return None
    path = Path(tok_dir) / "tokenizer.json"
    if not path.is_file():
        log(f"WARNING: no tokenizer.json under {tok_dir} (the port reads no "
            "spiece.model): the T5 text is hash-tokenized")
        return None
    return T5Tokenizer.from_file(path)
