"""The port's CLIP text encoders (``models/clip.py``) against the JAX
package's on the same weights (carried by ``models/from_jax.py``):
CLIP-L and CLIP-G at test size, ``SDXLTextStack`` and ``CLIPConditioner``
(hash fallback and BPE), fp32 at 2e-4; the full-width CLIP-L and
OpenCLIP-G trees carry leaf for leaf (shapes only)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.models import clip as jclip  # noqa: E402
from comfyui_distributed_tpu.models import tokenizer as jtok  # noqa: E402
from comfyui_distributed_tpu_torch.models import clip as tclip  # noqa: E402
from comfyui_distributed_tpu_torch.models import tokenizer as ttok  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import (carry_plan,  # noqa: E402
                                                           load_from_jax)
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
G_KW = dict(width=48, heads=2, act="gelu", projection_dim=48)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        tree)


def _pair(seed, **kw):
    jm = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny(**kw)).init(
        jax.random.key(seed))
    jm.params = _perturbed(jm.params, seed)
    tm = load_from_jax(tclip.CLIPTextTransformer(tclip.CLIPTextConfig.tiny(**kw)),
                       jm.params).eval()
    return jm, tm


def _tokens(seed, batch=3, eot=127, n=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, eot, (batch, n))
    for b in range(batch):
        toks[b, 3 + 4 * b] = eot                   # EOT at different places
    return toks


def test_configs_match_jax():
    import dataclasses

    for name in ("clip_l", "clip_g", "tiny"):
        j = dataclasses.asdict(getattr(jclip.CLIPTextConfig, name)())
        j.pop("dtype")
        assert j == dataclasses.asdict(getattr(tclip.CLIPTextConfig, name)())


@pytest.mark.parametrize("kw", [{}, G_KW], ids=["clip_l", "clip_g"])
def test_tower_matches_jax(kw):
    jm, tm = _pair(1, **kw)
    toks = _tokens(2)
    ref = jm(jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks))
    assert set(out) == set(ref)
    assert ("projected" in out) == bool(kw)
    for k in ref:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=TOL, rtol=TOL)


def test_causal_mask_and_eot_pooling():
    _, tm = _pair(3)
    toks = torch.from_numpy(_tokens(4, batch=1))
    later = toks.clone()
    later[0, 10:] = 5                      # tokens after position 9 change
    with torch.no_grad():
        a, b = tm(toks), tm(later)
    torch.testing.assert_close(a["last_hidden"][:, :10], b["last_hidden"][:, :10])
    assert not torch.allclose(a["last_hidden"][:, 10:], b["last_hidden"][:, 10:])
    eot = int(torch.nonzero(toks[0] == 127)[0])
    torch.testing.assert_close(a["pooled"][0], a["last_hidden"][0, eot])


def _stacks(seed=5):
    jl, tl = _pair(seed)
    jg, tg = _pair(seed + 1, **G_KW)
    return jclip.SDXLTextStack(jl, jg), tclip.SDXLTextStack(tl, tg)


def test_sdxl_stack_matches_jax():
    jstack, tstack = _stacks()
    tl, tg = _tokens(6), _tokens(7)
    ctx, pooled = jstack.encode_tokens(jnp.asarray(tl, jnp.int32),
                                       jnp.asarray(tg, jnp.int32))
    with torch.no_grad():
        tctx, tpooled = tstack.encode_tokens(torch.from_numpy(tl),
                                             torch.from_numpy(tg))
    assert tuple(tctx.shape) == (3, 16, 80) and tuple(tpooled.shape) == (3, 48)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(ctx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=TOL,
                               rtol=TOL)


def _vocab_dir(tmp_path, vocab_size=128):
    """A vocabulary whose ids fit the tiny towers: printable ASCII bytes
    with and without ``</w>``, a few merges, EOT at ``vocab_size`` - 1."""
    table = jtok.bytes_to_unicode()
    units = [table[b] for b in range(ord("a"), ord("z") + 1)] + [table[ord(" ")]]
    vocab = {u: i for i, u in enumerate(units + [u + "</w>" for u in units])}
    merges = [("c", "a"), ("ca", "t</w>"), ("d", "o"), ("do", "g</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab[jtok.SOT] = vocab_size - 2
    vocab[jtok.EOT] = vocab_size - 1
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return tmp_path


@pytest.mark.parametrize("vocab", [False, True], ids=["hash", "bpe"])
@pytest.mark.parametrize("kind", ["sdxl", "clip-l"])
def test_conditioner_matches_jax(kind, vocab, tmp_path, monkeypatch):
    if vocab:
        monkeypatch.setenv("CDT_TOKENIZER_DIR", str(_vocab_dir(tmp_path)))
    else:
        monkeypatch.delenv("CDT_TOKENIZER_DIR", raising=False)
    if kind == "sdxl":
        jstack, tstack = _stacks(8)
    else:
        jstack, tstack = _pair(8)
    jc = jclip.CLIPConditioner(jstack, kind=kind)
    tc = tclip.CLIPConditioner(tstack, kind=kind)
    texts = ["a cat", "dog and cat on a mat", ""]
    assert tc.tokenization_mode == ("bpe" if vocab else "hash")
    assert tc.token_signature(texts) == jc.token_signature(texts)
    ctx, pooled = jc.encode(texts)
    tctx, tpooled = tc.encode(texts)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(ctx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=TOL,
                               rtol=TOL)


def test_conditioner_refuses_mismatched_vocab(tmp_path, monkeypatch):
    _, tstack = _stacks(9)
    monkeypatch.setenv("CDT_TOKENIZER_DIR", str(_vocab_dir(tmp_path, 200)))
    with pytest.raises(ValueError, match="does not match the clip_l tower"):
        tclip.CLIPConditioner(tstack, kind="sdxl")
    tok = ttok.CLIPBPETokenizer.from_dir(tmp_path)
    with pytest.raises(ValueError, match="both tok_l and tok_g"):
        tclip.CLIPConditioner(tstack, kind="sdxl", tok_l=tok)


@pytest.mark.parametrize("name", ["clip_l", "clip_g"])
def test_full_width_trees_carry(name):
    """Every leaf of the full-width JAX tower lands on one port parameter
    of the right shape (JAX tree as shapes, port module on meta)."""
    cfg = getattr(jclip.CLIPTextConfig, name)()
    tree = jax.eval_shape(jclip.CLIPTextTransformer(cfg).init, jax.random.key(0),
                          jnp.zeros((1, cfg.max_len), jnp.int32))
    with torch.device("meta"):
        module = tclip.CLIPTextTransformer(getattr(tclip.CLIPTextConfig, name)())
    plan = carry_plan(tree, module)
    assert len(plan) == len(jax.tree_util.tree_leaves(tree))
    n = sum(p.numel() for p in module.parameters())
    assert n == {"clip_l": 123_060_480, "clip_g": 694_659_840}[name]
