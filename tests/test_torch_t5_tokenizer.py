"""The port's T5 tokenizer (``models/t5_tokenizer.py``) against HF
``tokenizers`` and the JAX package's ``t5_token_ids``: synthetic
``tokenizer.json`` files (a Unigram vocabulary with seeded scores, a
``Precompiled`` charsmap written by the port's ``encode_charsmap``, both
published ``Metaspace`` forms, the ``$A </s>`` template) give the same
ids and masks as a ``transformers.PreTrainedTokenizerFast`` over the same
file handed to JAX ``t5_token_ids``: padding, truncation at ``max_len``
keeping ``</s>``, unknown characters, repeated spaces, added tokens.
``Precompiled`` equals ``tokenizers.normalizers.Precompiled`` on the
same charsmap bytes, except for the one divergence the module states (a
Prepend character). Exact equality throughout (ids are integers)."""

import base64
import json

import numpy as np
import pytest

from comfyui_distributed_tpu_torch.models import t5_tokenizer as ttok

WORDS = ("a photo of the cat on red car lighthouse at dawn crashing waves "
         "painting oil blurry low quality ab ac ad").split()
# fullwidth ASCII, NBSP, a ligature, a decomposed é, a Prepend character
CHARSMAP = {**{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},
            " ": " ", "ﬁ": "fi", "é": "é", "؀": "#",
            "Ⅻ": "XII"}
TEXTS = [
    "a photo of the cat",
    "A Photo  of   the    cat",                    # case, repeated spaces
    "  leading and trailing  ",
    "ＦＵＬＬＷＩＤＴＨ ｃａｔ！",                      # mapped by the charsmap
    "ﬁne day, café and café",
    "unknown ζλ漢字 chars ✓✓ end",
    "specials </s> inside <extra_id_0> text<pad>",
    "",
    " ".join(["lighthouse at dawn crashing waves"] * 12),   # past max_len
    "Ⅻ a\tb\nc",
]


def _vocab(seed=0):
    """[piece, score] in id order: the specials, the bare marker and
    every character of the test words, then words and their pieces."""
    rng = np.random.default_rng(seed)
    pieces = ["▁"] + sorted(set("".join(WORDS)) | set("ABCDEFGHIJKLMNOPQRSTUVWXYZ,!éfiXI#"))
    for w in WORDS:
        pieces += ["▁" + w, w, "▁" + w[:2], w[: len(w) // 2], w[len(w) // 2:]]
    seen, vocab = set(), [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    for p in pieces:
        if p not in seen:
            seen.add(p)
            vocab.append([p, float(-rng.uniform(1.0, 12.0))])
    return vocab


def tokenizer_json(form: str = "always", seed: int = 0) -> dict:
    """A T5 ``tokenizer.json`` in one of the published pre-tokenizer
    forms: ``always`` (Metaspace, prepend_scheme/split), ``legacy``
    (WhitespaceSplit then Metaspace with add_prefix_space), ``first``."""
    vocab = _vocab(seed)
    n = len(vocab)
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, c in enumerate(["<pad>", "</s>", "<unk>"])]
    added.append({"id": n, "content": "<extra_id_0>", "single_word": False,
                  "lstrip": False, "rstrip": False, "normalized": False,
                  "special": True})
    vocab = vocab + [["<extra_id_0>", 0.0]]
    meta = {"type": "Metaspace", "replacement": "▁"}
    if form == "legacy":
        pre = {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"},
            {**meta, "add_prefix_space": True}]}
    else:
        pre = {**meta, "prepend_scheme": form, "split": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
                ttok.encode_charsmap(CHARSMAP)).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": pre,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                        "tokens": ["</s>"]}}},
        "decoder": {"type": "Metaspace", "replacement": "▁",
                    "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab,
                  "byte_fallback": False},
    }


def _write(tmp_path, form):
    path = tmp_path / form / "tokenizer.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(tokenizer_json(form)), encoding="utf-8")
    return path


@pytest.mark.parametrize("form", ["always", "legacy", "first"])
def test_ids_match_hf_tokenizers(form, tmp_path):
    """Untruncated ids against ``tokenizers.Tokenizer`` (template
    included), on every test text."""
    tokenizers = pytest.importorskip("tokenizers")
    path = _write(tmp_path, form)
    hf = tokenizers.Tokenizer.from_file(str(path))
    port = ttok.T5Tokenizer.from_file(path)
    for text in TEXTS:
        assert port.tokenize(text) + [1] == hf.encode(text).ids, text
    assert any(2 in hf.encode(t).ids for t in TEXTS)       # <unk> happened


@pytest.mark.parametrize("form", ["always", "legacy"])
def test_token_ids_match_jax(form, tmp_path):
    """The port's ``t5_token_ids`` (padding to ``max_len`` 16, truncation
    keeping ``</s>``, the mask) against JAX ``t5_token_ids`` handed a
    ``PreTrainedTokenizerFast`` over the same file."""
    pytest.importorskip("flax")
    transformers = pytest.importorskip("transformers")
    from comfyui_distributed_tpu.models import t5 as jt5
    from comfyui_distributed_tpu_torch.models import t5 as tt5

    path = _write(tmp_path, form)
    hf = transformers.PreTrainedTokenizerFast(
        tokenizer_file=str(path), pad_token="<pad>", eos_token="</s>",
        unk_token="<unk>")
    jids, jmask = jt5.t5_token_ids(jt5.T5Config.tiny(), hf, TEXTS)
    ids, mask = tt5.t5_token_ids(tt5.T5Config.tiny(),
                                 ttok.T5Tokenizer.from_file(path), TEXTS)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    long = TEXTS.index(" ".join(["lighthouse at dawn crashing waves"] * 12))
    assert ids[long, -1] == 1 and mask[long].all()         # </s> kept
    assert ids[TEXTS.index(""), 0] == 1 and mask[TEXTS.index("")].sum() == 1


def test_hash_fallback_matches_jax():
    pytest.importorskip("flax")
    from comfyui_distributed_tpu.models import t5 as jt5
    from comfyui_distributed_tpu_torch.models import t5 as tt5

    jids, jmask = jt5.t5_token_ids(jt5.T5Config.tiny(), None, TEXTS, count=False)
    ids, mask = tt5.t5_token_ids(tt5.T5Config.tiny(), None, TEXTS)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_precompiled_matches_hf():
    normalizers = pytest.importorskip("tokenizers.normalizers")
    blob = ttok.encode_charsmap(CHARSMAP)
    hf = normalizers.Precompiled(blob)
    port = ttok.Precompiled(blob)
    texts = TEXTS + ["é̈x", "ｱﾞ", "👍🏽 ok", "\r\n", "ﬁﬁ Ⅻ", "é́",
                     "🇺🇸 flag", "ａ́"]
    for text in texts:
        assert port(text) == hf.normalize_str(text), repr(text)


def test_precompiled_prepend_divergence():
    """The one divergence: HF treats a Prepend character and the
    character after it as one grapheme, replaced whole by the Prepend
    character's mapping; the port's clusters do not know Prepend, so it
    maps U+0600 and keeps what follows."""
    normalizers = pytest.importorskip("tokenizers.normalizers")
    blob = ttok.encode_charsmap(CHARSMAP)
    assert normalizers.Precompiled(blob).normalize_str("؀a") == "#"
    assert ttok.Precompiled(blob)("؀a") == "#a"


def test_charsmap_encoder_round_trip():
    blob = ttok.encode_charsmap({"ab": "X", "a": "Y", "é": "e"})
    port = ttok.Precompiled(blob)
    # HF's rule: the first (shortest) match of a cluster
    assert port.transform("ab") == "Y" and port.transform("é") == "e"
    assert port.transform("b") is None
    with pytest.raises(ValueError, match="empty or holds NUL"):
        ttok.encode_charsmap({"": "x"})


@pytest.mark.parametrize("part,spec,name", [
    ("normalizer", {"type": "NFKC"}, "NFKC"),
    ("pre_tokenizer", {"type": "ByteLevel"}, "ByteLevel"),
    ("model", {"type": "BPE", "vocab": {}, "merges": []}, "BPE"),
    ("post_processor", {"type": "RobertaProcessing"}, "RobertaProcessing"),
])
def test_unknown_types_raise_naming_them(part, spec, name):
    data = tokenizer_json()
    data[part] = spec
    with pytest.raises(ValueError, match=name):
        ttok.T5Tokenizer(data)


def test_load_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("CDT_T5_TOKENIZER_DIR", raising=False)
    assert ttok.load_t5_tokenizer() is None
    monkeypatch.setenv("CDT_T5_TOKENIZER_DIR", str(tmp_path))
    assert ttok.load_t5_tokenizer() is None              # no tokenizer.json
    _write(tmp_path, "always").rename(tmp_path / "tokenizer.json")
    tok = ttok.load_t5_tokenizer()
    assert isinstance(tok, ttok.T5Tokenizer)
    words = tok.tokenize("a cat")
    pad = 5 - len(words)
    assert tok.encode("a cat", 6) == (words + [1] + [0] * pad,
                                      [1] * (len(words) + 1) + [0] * pad)
