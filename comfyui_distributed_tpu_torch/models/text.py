"""Hash-tokenised text encoder (counterpart of the JAX ``models/text.py``).

Strings → (context [B,N,output_dim], pooled [B,pooled_dim]). Tokenization
is the same stable blake2s hash as the JAX package, so both sides see the
same token ids. The MLP uses the tanh GELU (flax's ``nn.gelu`` default);
``ctx_proj``/``pool_proj`` run in fp32; the pooled vector is taken at the
first EOT token (id 1).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import torch_dtype
from .layers import LN_EPS, Attention


def _stable_hash_token(word: str, vocab_size: int) -> int:
    h = hashlib.blake2s(word.encode("utf-8"), digest_size=4).digest()
    return int.from_bytes(h, "little") % (vocab_size - 2) + 2   # 0=pad, 1=eot


def hash_tokenize(text: str, max_len: int, vocab_size: int) -> list[int]:
    toks = [_stable_hash_token(w, vocab_size) for w in text.lower().split()]
    toks = toks[: max_len - 1] + [1]
    return toks + [0] * (max_len - len(toks))


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 49408
    max_len: int = 77
    width: int = 768
    layers: int = 4
    heads: int = 12
    output_dim: int = 2048
    pooled_dim: int = 1280
    dtype: str = "bfloat16"

    @classmethod
    def tiny(cls, dtype: str = "bfloat16") -> "TextEncoderConfig":
        return cls(vocab_size=1024, max_len=16, width=32, layers=1, heads=2,
                   output_dim=32, pooled_dim=16, dtype=dtype)


class TextTransformer(nn.Module):
    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        self.config = cfg = config
        dt = torch_dtype(cfg.dtype)
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.width, dtype=dt)
        self.pos_emb = nn.Parameter(torch.zeros(cfg.max_len, cfg.width))
        head_dim = cfg.width // cfg.heads
        for i in range(cfg.layers):
            # flax numbers the unnamed LayerNorms in call order: 2i before
            # the attention of layer i, 2i+1 before its MLP
            self.add_module(f"LayerNorm_{2 * i}",
                            nn.LayerNorm(cfg.width, eps=LN_EPS, dtype=dt))
            self.add_module(f"attn_{i}",
                            Attention(cfg.width, cfg.heads, head_dim, dt))
            self.add_module(f"LayerNorm_{2 * i + 1}",
                            nn.LayerNorm(cfg.width, eps=LN_EPS, dtype=dt))
            self.add_module(f"mlp_{i}_up",
                            nn.Linear(cfg.width, cfg.width * 4, dtype=dt))
            self.add_module(f"mlp_{i}_down",
                            nn.Linear(cfg.width * 4, cfg.width, dtype=dt))
        self.final_ln = nn.LayerNorm(cfg.width, eps=LN_EPS, dtype=dt)
        self.ctx_proj = nn.Linear(cfg.width, cfg.output_dim,
                                  dtype=torch.float32)
        self.pool_proj = nn.Linear(cfg.width, cfg.pooled_dim,
                                   dtype=torch.float32)

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """``pos_emb`` ~ normal(0.01), as the flax parameter."""
        self.pos_emb.normal_(0.0, 0.01, generator=generator)

    def forward(self, tokens: torch.Tensor):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        x = self.tok_emb(tokens) + self.pos_emb[: tokens.shape[1]].to(dt)
        for i in range(cfg.layers):
            x = x + getattr(self, f"attn_{i}")(
                getattr(self, f"LayerNorm_{2 * i}")(x))
            h = getattr(self, f"mlp_{i}_up")(
                getattr(self, f"LayerNorm_{2 * i + 1}")(x))
            x = x + getattr(self, f"mlp_{i}_down")(F.gelu(h, approximate="tanh"))
        x = self.final_ln(x)
        context = self.ctx_proj(x.float())
        eot = torch.argmax((tokens == 1).int(), dim=1)
        pooled_src = x[torch.arange(x.shape[0], device=x.device), eot]
        return context, self.pool_proj(pooled_src.float())


class TextEncoder:
    """Host-facing wrapper: strings → (context [B,N,D], pooled [B,P])."""

    def __init__(self, module: TextTransformer):
        self.config = module.config
        self.module = module

    def tokenize(self, texts: Sequence[str]) -> torch.Tensor:
        cfg = self.config
        ids = [hash_tokenize(t, cfg.max_len, cfg.vocab_size) for t in texts]
        return torch.tensor(ids, dtype=torch.long,
                            device=self.module.tok_emb.weight.device)

    @torch.no_grad()
    def encode(self, texts: Sequence[str]):
        return self.module(self.tokenize(texts))
