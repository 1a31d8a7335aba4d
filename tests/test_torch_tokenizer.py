"""The port's CLIP BPE tokenizer against the JAX package's (which needs
the ``regex`` package for its ``\\p{L}``/``\\p{N}`` classes; the port
builds them from ``unicodedata``): equal ids on a synthetic vocabulary
and on Unicode text, the same word split, and the hash fallback of
``tokenize_ids`` bitwise equal."""

import json

import numpy as np
import pytest

pytest.importorskip("regex")
pytest.importorskip("flax")

from comfyui_distributed_tpu.models import clip as jclip  # noqa: E402
from comfyui_distributed_tpu.models import tokenizer as jtok  # noqa: E402
from comfyui_distributed_tpu_torch.models import clip as tclip  # noqa: E402
from comfyui_distributed_tpu_torch.models import tokenizer as ttok  # noqa: E402

MERGES = [
    ("h", "e"), ("l", "l"), ("o", "</w>"), ("he", "ll"), ("hell", "o</w>"),
    ("w", "o"), ("r", "l"), ("d", "</w>"), ("wo", "rl"), ("worl", "d</w>"),
    ("t", "p"), ("u", "</w>"), ("tp", "u</w>"), ("1", "</w>"), ("a", "</w>"),
    ("c", "a"), ("ca", "t</w>"), ("l", "i"), ("li", "g"), ("lig", "h"),
    ("ligh", "t"), ("'", "s</w>"), ("é", "t"), ("ét", "é</w>"),
]

TEXTS = [
    "hello world",
    "Hello, WORLD!",
    "a hello  on   tpu",
    "hello's world'll 1 2 3 it's we've I'm you'd they're",
    "x" * 300,
    "",
    "punctuation!!! ... (grouping) <|endoftext|>",
    "a lighthouse at dawn, 1024x1024, 8k",
    "m² ½ ¼ Ⅻ ① x²+y² 3½",
    "été, naïve café, Übergröße, ÆØÅ",
    "東京の夜景 그리고 서울 写真",
    "Ελληνικά Кириллица עברית العربية हिन्दी ไทย",
    "cat 🐱🐈 fire🔥 ❤️ 👍🏽 flag 🇯🇵",
    "é combining, zero​width, tab\there\nnewline",
    "٣ ٤ ৫ 𝟙𝟚 ⁷",
]


def _vocab():
    units = list(jtok.bytes_to_unicode().values())
    vocab = {u: i for i, u in enumerate(units + [u + "</w>" for u in units])}
    for a, b in MERGES:
        vocab.setdefault(a + b, len(vocab))
    vocab[jtok.SOT] = len(vocab)
    vocab[jtok.EOT] = len(vocab)
    return vocab


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_vocab")
    (d / "vocab.json").write_text(json.dumps(_vocab(), ensure_ascii=False),
                                  encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in MERGES),
        encoding="utf-8")
    return d


@pytest.mark.parametrize("pad", [None, 0])
@pytest.mark.parametrize("text", TEXTS)
def test_ids_match_jax(vocab_dir, text, pad):
    ours = ttok.CLIPBPETokenizer.from_dir(vocab_dir, max_len=77,
                                          pad_token_id=pad)
    theirs = jtok.CLIPBPETokenizer.from_dir(vocab_dir, max_len=77,
                                            pad_token_id=pad)
    assert ours.encode(text) == theirs.encode(text)
    assert ours.tokenize_text(text) == theirs.tokenize_text(text)


def test_word_split_matches_regex_over_scripts():
    """The pattern itself on text from every script block up to U+FFFF
    that ``regex`` and ``unicodedata`` classify alike."""
    import regex
    import unicodedata

    letters = "".join(chr(c) for c in range(0x20, 0x3000, 7)
                      if unicodedata.category(chr(c))[0] in "LNPSZ")
    text = " ".join(letters[i:i + 9] for i in range(0, len(letters), 9))
    assert ttok._PATTERN.findall(text) == jtok._PATTERN.findall(text)
    assert jtok._re is regex


def test_bpe_merges_and_framing(vocab_dir):
    tok = ttok.CLIPBPETokenizer.from_dir(vocab_dir, max_len=16)
    assert tok.tokenize_text("hello") == [tok.vocab["hello</w>"]]
    out = tok.encode("hello world")
    assert out[:4] == [tok.sot_id, tok.vocab["hello</w>"],
                       tok.vocab["world</w>"], tok.eot_id]
    assert len(out) == 16 and set(out[4:]) == {tok.eot_id}
    assert len(tok.encode("x " * 40)) == 16 and tok.encode("x " * 40)[-1] == tok.eot_id


def test_from_env_and_pair_loading(vocab_dir, monkeypatch):
    monkeypatch.delenv("CDT_TOKENIZER_DIR", raising=False)
    assert ttok.CLIPBPETokenizer.from_env() is None
    assert ttok.load_sd_tokenizers() == (None, None)
    monkeypatch.setenv("CDT_TOKENIZER_DIR", str(vocab_dir))
    tok_l, tok_g = ttok.load_sd_tokenizers(max_len=20)
    assert tok_l.pad_token_id == tok_l.eot_id and tok_g.pad_token_id == 0
    assert tok_l.max_len == tok_g.max_len == 20
    monkeypatch.setenv("CDT_TOKENIZER_DIR", str(vocab_dir / "nowhere"))
    assert ttok.CLIPBPETokenizer.from_env() is None


@pytest.mark.parametrize("cfg", ["tiny", "clip_l"])
def test_hash_fallback_matches_jax(cfg):
    jcfg = getattr(jclip.CLIPTextConfig, cfg)()
    tcfg = getattr(tclip.CLIPTextConfig, cfg)()
    texts = TEXTS + ["one two three " * 40]
    for pad in (jcfg.eot_token_id, 0):
        ref = np.asarray(jclip.tokenize_ids(texts, None, jcfg, pad, count=False))
        out = tclip.tokenize_ids(texts, None, tcfg, pad)
        assert out.dtype.is_floating_point is False
        np.testing.assert_array_equal(out.numpy(), ref)


def test_bpe_ids_of_tokenize_ids_match_jax(vocab_dir):
    tok_j = jtok.CLIPBPETokenizer.from_dir(vocab_dir, max_len=77)
    tok_t = ttok.CLIPBPETokenizer.from_dir(vocab_dir, max_len=77)
    cfg = jclip.CLIPTextConfig.clip_l()
    ref = np.asarray(jclip.tokenize_ids(TEXTS, tok_j, cfg, cfg.eot_token_id,
                                        count=False))
    out = tclip.tokenize_ids(TEXTS, tok_t, tclip.CLIPTextConfig.clip_l(),
                             cfg.eot_token_id)
    np.testing.assert_array_equal(out.numpy(), ref)
