"""T5 text encoder and FLUX's text stack (counterpart of the JAX
``models/t5.py``).

- ``T5Encoder``: the encoder-only stack of T5 v1.1 (FLUX's T5-XXL) and
  UMT5: relative-position-bias attention (one table shared by every
  layer, or one per layer for UMT5), pre-RMSNorm, unscaled scores (T5
  folds 1/√d into its init), the additive bias and a −1e9 key mask, a
  gated tanh-GELU feed-forward.
- ``t5_token_ids``: strings → (ids, mask) of ``max_len``: the tokenizer of
  ``models/t5_tokenizer.py`` when one is loaded, else the JAX package's
  hash fallback (blake2s ids, ``</s>``, padding), so that masking works.
- ``FluxTextStack``: the conditioning pair FLUX checkpoints assume, the
  T5 context ``[B, 512, 4096]`` and CLIP-L's pooled vector ``[B, 768]``
  (``models/clip.py`` with the BPE tokenizer of ``models/tokenizer.py``),
  with ``encode``, ``token_signature`` and ``tokenization_mode`` like
  the other conditioners.

Everything runs in fp32, as the JAX config's ``dtype`` says. T5's
attention is an XLA einsum in the JAX package, not a Pallas kernel, so it
is plain PyTorch here (no kernel is owed). Attribute names follow the JAX
parameter tree (``shared``, ``rel_bias``/``rel_bias_{i}``,
``ln_attn_{i}/weight``, ``attn_{i}/{q,k,v,o}``, ``ln_ff_{i}/weight``,
``ff_{i}/{wi_0,wi_1,wo}``, ``final_ln/weight``), so that
``models/from_jax.py`` carries a JAX tree. ``UMT5Conditioner`` and
``SD3TextStack`` are not ported (ROADMAP items 15b and 13).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.logging import log
from .clip import (NEG_INF, CLIPTextConfig, CLIPTextTransformer,
                   tokenize_ids, validate_tokenizer_vocab)
from .t5_tokenizer import T5Tokenizer, load_t5_tokenizer
from .tokenizer import load_sd_tokenizers


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    d_kv: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    per_layer_rel_bias: bool = False     # UMT5: every layer owns a table
    max_len: int = 512
    dtype: str = "float32"

    @classmethod
    def xxl(cls) -> "T5Config":
        """google/t5-v1_1-xxl's encoder: FLUX's text tower."""
        return cls()

    @classmethod
    def umt5_xxl(cls) -> "T5Config":
        """google/umt5-xxl's encoder (WAN's text tower)."""
        return cls(vocab_size=256384, per_layer_rel_bias=True, max_len=512)

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        base = dict(vocab_size=128, d_model=32, d_ff=64, num_layers=2,
                    num_heads=4, d_kv=8, rel_buckets=8, rel_max_distance=16,
                    max_len=16)
        base.update(kw)
        return cls(**base)


def _rel_bucket(rel: torch.Tensor, num_buckets: int,
                max_distance: int) -> torch.Tensor:
    """T5's bidirectional relative-position buckets (HF's rule, in fp32
    as the JAX function computes them)."""
    num_buckets //= 2
    ret = (rel > 0).long() * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    nf = n.clamp(min=1).float()
    val_large = max_exact + (
        torch.log(nf / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class _T5LayerNorm(nn.Module):
    """RMS norm: no bias, no mean subtracted."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


class _T5Attention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        inner = cfg.num_heads * cfg.d_kv
        for name in ("q", "k", "v"):
            self.add_module(name, nn.Linear(cfg.d_model, inner, bias=False))
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, N, _ = x.shape
        shape = (B, N, self.heads, self.d_kv)
        q, k, v = (getattr(self, n)(x).view(shape) for n in ("q", "k", "v"))
        # no 1/√d: T5 folds it into its init
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias
        if mask is not None:
            s = s + mask
        p = torch.softmax(s.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, -1)
        return self.o(out)


class _T5FF(nn.Module):
    """Gated tanh-GELU feed-forward (T5 v1.1, UMT5)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5Encoder(nn.Module):
    """tokens [B, N] (and a mask [B, N] of 1s and 0s) → last hidden
    states [B, N, d_model], fp32."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = cfg = config
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        tables = ([f"rel_bias_{i}" for i in range(cfg.num_layers)]
                  if cfg.per_layer_rel_bias else ["rel_bias"])
        for name in tables:
            self.add_module(name, nn.Embedding(cfg.rel_buckets, cfg.num_heads))
        for i in range(cfg.num_layers):
            self.add_module(f"ln_attn_{i}",
                            _T5LayerNorm(cfg.d_model, cfg.layer_norm_eps))
            self.add_module(f"attn_{i}", _T5Attention(cfg))
            self.add_module(f"ln_ff_{i}",
                            _T5LayerNorm(cfg.d_model, cfg.layer_norm_eps))
            self.add_module(f"ff_{i}", _T5FF(cfg))
        self.final_ln = _T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def forward(self, tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        N = tokens.shape[1]
        x = self.shared(tokens)
        pos = torch.arange(N, device=tokens.device)
        buckets = _rel_bucket(pos[None, :] - pos[:, None], cfg.rel_buckets,
                              cfg.rel_max_distance)
        mask = None
        if attn_mask is not None:
            mask = (1.0 - attn_mask[:, None, None, :].float()) * NEG_INF

        def bias_of(name: str) -> torch.Tensor:
            return getattr(self, name)(buckets).permute(2, 0, 1)[None]

        shared = None if cfg.per_layer_rel_bias else bias_of("rel_bias")
        for i in range(cfg.num_layers):
            bias = bias_of(f"rel_bias_{i}") if shared is None else shared
            h = getattr(self, f"ln_attn_{i}")(x)
            x = x + getattr(self, f"attn_{i}")(h, bias, mask)
            h = getattr(self, f"ln_ff_{i}")(x)
            x = x + getattr(self, f"ff_{i}")(h)
        return self.final_ln(x)


def t5_token_ids(cfg: T5Config, tok: Optional[T5Tokenizer],
                 texts: Sequence[str]) -> tuple[torch.Tensor, torch.Tensor]:
    """Strings → (ids [B, max_len], mask [B, max_len]), int64 on the
    host: the tokenizer where one is loaded, else the JAX package's hash
    fallback (blake2s ids from 2, ``</s>`` = 1, pad 0)."""
    if tok is not None:
        pairs = [tok.encode(str(t), cfg.max_len) for t in texts]
    else:
        def fallback(text: str):
            ids = [int.from_bytes(
                hashlib.blake2s(w.encode(), digest_size=4).digest(),
                "little") % (cfg.vocab_size - 2) + 2
                for w in text.lower().split()][: cfg.max_len - 1] + [1]
            pad = cfg.max_len - len(ids)
            return ids + [0] * pad, [1] * len(ids) + [0] * pad
        pairs = [fallback(str(t)) for t in texts]
    return (torch.tensor([p[0] for p in pairs], dtype=torch.long),
            torch.tensor([p[1] for p in pairs], dtype=torch.long))


class FluxTextStack(nn.Module):
    """FLUX's conditioning: ``encode(texts)`` → (T5 last hidden states
    [B, max_len, d_model], CLIP-L's pooled EOT vector [B, 768]) on the
    stack's device, a drop-in for the other text encoders of the graph
    nodes. The T5 tokenizer comes from ``CDT_T5_TOKENIZER_DIR``, CLIP-L's
    vocabulary from ``CDT_TOKENIZER_DIR``; without either that tower
    hash-tokenises and a warning says so."""

    def __init__(self, t5: T5Encoder, clip_l: CLIPTextTransformer,
                 t5_tok: Optional[T5Tokenizer] = None, clip_tok=None):
        super().__init__()
        self.t5 = t5
        self.clip_l = clip_l
        self.t5_tok = t5_tok if t5_tok is not None else load_t5_tokenizer()
        if clip_tok is None:
            # the tower's own context length: its position table covers
            # only config.max_len
            clip_tok, _ = load_sd_tokenizers(max_len=clip_l.config.max_len)
            if clip_tok is not None:
                validate_tokenizer_vocab(clip_tok, clip_l.config, "clip_l")
        self.clip_tok = clip_tok
        if self.t5_tok is None:
            log("WARNING: no T5 tokenizer (CDT_T5_TOKENIZER_DIR): the T5 "
                "text is hash-tokenized; conditioning will not reflect the "
                "prompt")
        if self.clip_tok is None:
            log("WARNING: no CLIP vocab at CDT_TOKENIZER_DIR: the pooled "
                "vector is hash-tokenized and will not reflect the prompt")

    @staticmethod
    def configs(tiny: bool = False) -> tuple[T5Config, CLIPTextConfig]:
        if tiny:
            return T5Config.tiny(), CLIPTextConfig.tiny()
        return T5Config.xxl(), CLIPTextConfig.clip_l()

    @property
    def device(self) -> torch.device:
        return self.t5.device

    def _ids(self, texts: list[str]):
        ids, mask = t5_token_ids(self.t5.config, self.t5_tok, texts)
        cfg = self.clip_l.config
        return ids, mask, tokenize_ids(texts, self.clip_tok, cfg,
                                       cfg.eot_token_id)

    def token_signature(self, texts) -> tuple[list, str]:
        """(T5 ids and mask, CLIP-L ids; the real-vs-hash mode of each)."""
        ids, mask, toks = self._ids([str(t) for t in texts])
        mode = (f"t5={'sp' if self.t5_tok is not None else 'hash'},"
                f"l={'bpe' if self.clip_tok is not None else 'hash'}")
        return [ids.tolist(), mask.tolist(), toks.tolist()], mode

    @property
    def tokenization_mode(self) -> str:
        """"real" when both towers have their tokenizer, else "hash"."""
        return ("real" if self.t5_tok is not None and self.clip_tok is not None
                else "hash")

    @torch.no_grad()
    def encode(self, texts) -> tuple[torch.Tensor, torch.Tensor]:
        dev = self.device
        ids, mask, toks = self._ids([str(t) for t in texts])
        context = self.t5(ids.to(dev), mask.to(dev))
        return context, self.clip_l(toks.to(dev))["pooled"]
