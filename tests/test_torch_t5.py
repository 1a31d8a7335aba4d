"""The port's T5 (``models/t5.py``) and its converter walk
(``convert.convert_t5``) against the JAX package's, on tiny fp32 towers
with seeded weights: the encoder with a key mask, with the shared and the
per-layer (UMT5) bias tables, within 2e-5; the relative-position buckets
at T5-XXL's 512 tokens exactly; ``convert_t5`` on an HF-layout dict
written by the port's exporter against JAX ``convert_t5`` (equal trees,
the tied embedding consumed, a stray key refused by both); and
``FluxTextStack.encode`` (T5 context + CLIP-L pooled) against JAX's,
hash-tokenised and with real tokenizers, within 2e-4."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.models import t5 as jt5  # noqa: E402
from comfyui_distributed_tpu_torch.models import clip as tclip  # noqa: E402
from comfyui_distributed_tpu_torch.models import convert as tconvert  # noqa: E402
from comfyui_distributed_tpu_torch.models import t5 as tt5  # noqa: E402
from comfyui_distributed_tpu_torch.models.convert import ConversionError  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from torch_ckpt_fixtures import perturbed  # noqa: E402

MODULE_TOL, STACK_TOL = 2e-5, 2e-4
PROMPTS = ["a photo of the cat on a red car", "lighthouse at dawn", ""]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(per_layer: bool, seed: int = 0):
    """A JAX T5Model (weights perturbed off their init) and the port's
    encoder carrying them."""
    cfg = jt5.T5Config.tiny(per_layer_rel_bias=per_layer)
    model = jt5.T5Model(cfg).init(jax.random.key(seed))
    model.params = perturbed(_np(model.params), seed + 1)
    port = tt5.T5Encoder(tt5.T5Config.tiny(per_layer_rel_bias=per_layer))
    return model, load_from_jax(port, model.params).eval()


@pytest.mark.parametrize("per_layer", [False, True], ids=["shared", "per_layer"])
def test_encoder_matches_jax(per_layer):
    model, port = _pair(per_layer)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    for m in (mask, None):
        ref = np.asarray(model(jnp.asarray(ids), None if m is None
                               else jnp.asarray(m)))
        with torch.no_grad():
            out = port(torch.from_numpy(ids).long(),
                       None if m is None else torch.from_numpy(m))
        assert out.dtype == torch.float32 and np.abs(ref).max() > 0.1
        np.testing.assert_allclose(out.numpy(), ref, atol=MODULE_TOL,
                                   rtol=MODULE_TOL)
    names = {n.split(".")[0] for n, _ in port.named_parameters()}
    assert ({"rel_bias_0", "rel_bias_1"} <= names) == per_layer
    assert ("rel_bias" in names) != per_layer


def test_rel_buckets_match_jax_at_xxl():
    cfg = tt5.T5Config.xxl()
    pos = np.arange(cfg.max_len)
    rel = pos[None, :] - pos[:, None]
    ref = np.asarray(jt5._rel_bucket(jnp.asarray(rel), cfg.rel_buckets,
                                     cfg.rel_max_distance))
    got = tt5._rel_bucket(torch.from_numpy(rel), cfg.rel_buckets,
                          cfg.rel_max_distance)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.min() == 0 and ref.max() == cfg.rel_buckets - 1


@pytest.mark.parametrize("per_layer", [False, True], ids=["shared", "per_layer"])
def test_convert_t5_matches_jax(per_layer):
    model, port = _pair(per_layer, seed=3)
    sd = {k: v.detach().clone() for k, v in tconvert.export_t5(port).items()}
    assert tconvert.T5_TIED in sd and "shared.weight" in sd
    cfg = model.config
    template = jt5.T5Model(cfg).init(jax.random.key(0), abstract=True).params
    jtree = jt5.convert_t5({k: v.numpy() for k, v in sd.items()}, template, cfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(model.params):
        got = jtree
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf))
    fresh = tt5.T5Encoder(tt5.T5Config.tiny(per_layer_rel_bias=per_layer))
    tconvert.convert_t5(sd, fresh)
    for name, p in port.named_parameters():
        assert torch.equal(fresh.get_parameter(name), p), name
    # a stray key: both refuse
    sd["encoder.block.0.layer.2.bogus.weight"] = torch.zeros(1)
    with pytest.raises(ConversionError, match="unconsumed source keys"):
        tconvert.convert_t5(sd, fresh)
    with pytest.raises(Exception, match="unconsumed T5 keys"):
        jt5.convert_t5({k: v.numpy() for k, v in sd.items()}, template, cfg)


def _stacks(t5_tok=None, clip_tok_pair=(None, None)):
    """JAX FluxTextStack (tiny, weights perturbed) and the port's with the
    same weights and tokenizers."""
    jstack = jt5.FluxTextStack.init_random(jax.random.key(7), tiny=True)
    jstack.t5.params = perturbed(_np(jstack.t5.params), 8)
    jstack.clip_l.params = perturbed(_np(jstack.clip_l.params), 9)
    jt5_tok, tt5_tok = t5_tok or (None, None)
    jstack.t5_tok = jt5_tok
    jstack.clip_tok = clip_tok_pair[0]
    cfg_t5, cfg_l = tt5.FluxTextStack.configs(tiny=True)
    port = tt5.FluxTextStack(
        load_from_jax(tt5.T5Encoder(cfg_t5), jstack.t5.params),
        load_from_jax(tclip.CLIPTextTransformer(cfg_l), jstack.clip_l.params),
        t5_tok=tt5_tok, clip_tok=clip_tok_pair[1]).eval()
    return jstack, port


def _compare(jstack, port):
    jctx, jpooled = jstack.encode(PROMPTS)
    ctx, pooled = port.encode(PROMPTS)
    assert ctx.shape == (3, 16, 32) and pooled.shape == (3, 32)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=STACK_TOL,
                               rtol=STACK_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               atol=STACK_TOL, rtol=STACK_TOL)
    jsig, jmode = jstack.token_signature(PROMPTS)
    sig, mode = port.token_signature(PROMPTS)
    assert sig == [np.asarray(s).tolist() for s in jsig] and mode == jmode


def test_flux_text_stack_hash_matches_jax(monkeypatch):
    monkeypatch.delenv("CDT_T5_TOKENIZER_DIR", raising=False)
    monkeypatch.delenv("CDT_TOKENIZER_DIR", raising=False)
    jstack, port = _stacks()
    assert port.tokenization_mode == jstack.tokenization_mode == "hash"
    _compare(jstack, port)


def test_flux_text_stack_real_tokenizers_match_jax(tmp_path, monkeypatch):
    """With a T5 ``tokenizer.json`` and a CLIP vocabulary: the JAX stack
    gets a ``PreTrainedTokenizerFast`` and JAX's BPE tokenizer, the port
    its own readers of the same files (through the environment)."""
    transformers = pytest.importorskip("transformers")
    from comfyui_distributed_tpu.models.tokenizer import CLIPBPETokenizer as JTok
    from test_torch_clip import _vocab_dir
    from test_torch_t5_tokenizer import tokenizer_json

    t5_dir = tmp_path / "t5"
    t5_dir.mkdir()
    (t5_dir / "tokenizer.json").write_text(json.dumps(tokenizer_json()),
                                           encoding="utf-8")
    vocab = _vocab_dir(tmp_path, 128)
    monkeypatch.setenv("CDT_T5_TOKENIZER_DIR", str(t5_dir))
    monkeypatch.setenv("CDT_TOKENIZER_DIR", str(vocab))
    hf = transformers.PreTrainedTokenizerFast(
        tokenizer_file=str(t5_dir / "tokenizer.json"), pad_token="<pad>",
        eos_token="</s>", unk_token="<unk>")
    jtok = JTok.from_dir(vocab, max_len=16)
    jstack, port = _stacks((hf, None), (jtok, None))
    assert port.tokenization_mode == jstack.tokenization_mode == "real"
    _compare(jstack, port)


def test_bundle_carries_a_jax_flux_text_stack(monkeypatch):
    """``ModelBundle.load_from_jax(t5=, clip_l=)`` fills a FLUX bundle's
    stack (here ``flux-tiny`` with the tiny T5 + CLIP-L stack), which
    then encodes as the JAX stack does."""
    import dataclasses

    from comfyui_distributed_tpu.models import dit as jdit
    from comfyui_distributed_tpu.models import vae as jvae
    from comfyui_distributed_tpu_torch.models import registry as treg

    monkeypatch.delenv("CDT_T5_TOKENIZER_DIR", raising=False)
    monkeypatch.delenv("CDT_TOKENIZER_DIR", raising=False)
    base = treg.PRESETS["flux-tiny"]
    preset = dataclasses.replace(base, clip="flux", dit=dataclasses.replace(
        base.dit, pooled_dim=32))
    jstack, _ = _stacks()
    key = jax.random.key(0)
    _, dit = jdit.init_dit(jdit.DiTConfig.tiny(pooled_dim=32), key,
                           sample_hw=(8, 8), context_len=16)
    dec = jax.jit(jvae.AutoencoderKL(jvae.VAEConfig.tiny()).decoder.init)(
        key, jnp.zeros((1, 8, 8, 4)))
    bundle = treg.ModelBundle(preset, "cpu").load_from_jax(
        _np(dit), _np(dec), t5=jstack.t5.params, clip_l=jstack.clip_l.params)
    assert bundle.text_encoder is bundle.clip_stack
    assert sorted(bundle._state_entries()) == ["clip_l", "core", "t5", "vae_dec"]
    ctx, pooled = bundle.text_encoder.encode(PROMPTS)
    jctx, jpooled = jstack.encode(PROMPTS)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=STACK_TOL,
                               rtol=STACK_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               atol=STACK_TOL, rtol=STACK_TOL)
