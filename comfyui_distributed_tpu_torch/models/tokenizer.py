"""CLIP byte-pair-encoding tokenizer (counterpart of the JAX
``models/tokenizer.py``): the OpenAI CLIP tokenizer SD 1.5 and SDXL
were trained with, over a vocabulary loaded from files.

- the byte → printable-unicode table, lowercased input, collapsed
  whitespace;
- CLIP's word-splitting pattern (the specials, contraction suffixes,
  runs of letters, single numbers, runs of anything else that is not
  whitespace);
- greedy lowest-rank BPE merges with the ``</w>`` end-of-word marker;
- ``<|startoftext|>`` / ``<|endoftext|>``, truncated then padded to
  ``max_len``.

One departure: the JAX module compiles its pattern with the ``regex``
package, whose ``\\p{L}`` / ``\\p{N}`` classes the standard ``re``
refuses (it falls back to ``re`` and then fails at import). The port
builds both classes from ``unicodedata`` (categories L* and N*) once, at
import, and compiles them with ``re``.

Vocabularies are the ``vocab.json`` + ``merges.txt`` pair of every SD
distribution, from ``CDT_TOKENIZER_DIR``; none ships with the repo.
CLIP-L pads with EOT, CLIP-G with 0 (``pad_token_id``).
"""

from __future__ import annotations

import functools
import json
import re
import sys
import unicodedata
from pathlib import Path
from typing import Optional, Sequence

from ..utils import constants

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


def _char_class(prefix: str) -> str:
    """A regex class body of every code point whose general category
    starts with ``prefix``, as ranges."""
    ranges, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    return "".join(re.escape(chr(a)) if a == b
                   else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in ranges)


_L = _char_class("L")
_N = _char_class("N")
_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    rf"[{_L}]+|[{_N}]|[^\s{_L}{_N}]+",
    re.IGNORECASE)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2/CLIP reversible byte → printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class CLIPBPETokenizer:
    def __init__(self, vocab: dict[str, int],
                 merges: Sequence[tuple[str, str]], max_len: int = 77,
                 pad_token_id: Optional[int] = None):
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.max_len = max_len
        self.byte_encoder = bytes_to_unicode()
        self.sot_id = self.vocab[SOT]
        self.eot_id = self.vocab[EOT]
        self.pad_token_id = self.eot_id if pad_token_id is None else pad_token_id
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_dir(cls, path: Path, **kw) -> "CLIPBPETokenizer":
        """Load the HF-format ``vocab.json`` + ``merges.txt``."""
        path = Path(path)
        vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
        merges = []
        for line in (path / "merges.txt").read_text(encoding="utf-8").splitlines():
            if line.startswith("#version") or not line.strip():
                continue
            a, b = line.split()
            merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_env(cls, subdir: str = "", **kw) -> Optional["CLIPBPETokenizer"]:
        """The vocabulary under ``CDT_TOKENIZER_DIR`` (or its ``subdir``),
        or None where there is none."""
        root = constants.tokenizer_dir()
        if not root:
            return None
        path = Path(root) / subdir if subdir else Path(root)
        if not (path / "vocab.json").is_file():
            return None
        return cls.from_dir(path, **kw)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = _get_pairs(word)
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            a, b = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = list(word)
        return list(word)

    def tokenize_text(self, text: str) -> list[int]:
        """Text → BPE ids (no specials, no padding)."""
        text = " ".join(text.split()).strip().lower()
        ids: list[int] = []
        for tok in _PATTERN.findall(text):
            encoded = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[unit] for unit in self._bpe(encoded))
        return ids

    def encode(self, text: str) -> list[int]:
        """Text → fixed-length [SOT, …, EOT, pad…] ids."""
        ids = self.tokenize_text(text)[: self.max_len - 2]
        out = [self.sot_id] + ids + [self.eot_id]
        return out + [self.pad_token_id] * (self.max_len - len(out))


def load_sd_tokenizers(max_len: int = 77):
    """(CLIP-L tokenizer, CLIP-G tokenizer) from ``CDT_TOKENIZER_DIR``, or
    ``(None, None)`` without a vocabulary (the hash fallback). Both share
    one vocabulary and differ in the padding id."""
    tok_l = CLIPBPETokenizer.from_env(max_len=max_len)
    if tok_l is None:
        return None, None
    tok_g = CLIPBPETokenizer.from_env(max_len=max_len, pad_token_id=0)
    return tok_l, tok_g
