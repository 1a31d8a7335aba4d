"""CLIP text encoders with the published computation (counterpart of the
JAX ``models/clip.py``): SD 1.5's CLIP-L and SDXL's CLIP-L + OpenCLIP
bigG stack, so that converted checkpoints condition as they were
trained.

- pre-LN residual blocks with a causal attention mask (additive -1e9),
- ``quick_gelu`` (CLIP-L) or exact-erf ``gelu`` (CLIP-G) in the MLP,
- the pooled vector at the first EOT token, optionally projected
  (``text_projection``, CLIP-G),
- the penultimate layer's hidden states (SDXL's context).

Everything runs in fp32, as the JAX config's ``dtype`` says. The JAX
attention is an XLA einsum with a mask, not a Pallas kernel, so it is
plain PyTorch here (no kernel is owed, and SDPA is not used). Attribute
names follow the JAX parameter tree (``tok_emb``, ``pos_emb``,
``layer_{i}/{ln1,attn/{q,k,v,out}_proj,ln2,fc1,fc2}``, ``final_ln``,
``text_projection``), so ``models/from_jax.py`` carries a JAX tree.

SDXL's contract: context = concat(L.penultimate [768], G.penultimate
[1280]) = 2048 wide; pooled = G's projected EOT vector, 1280 wide.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.logging import log
from .text import count_hash_tokenization
from .tokenizer import CLIPBPETokenizer, load_sd_tokenizers

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_len: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    act: str = "quick_gelu"            # CLIP-L; CLIP-G uses "gelu"
    eot_token_id: int = 49407
    projection_dim: int = 0            # 0: no text_projection
    layer_norm_eps: float = 1e-5

    @classmethod
    def clip_l(cls) -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14's text tower (SD 1.5, SDXL)."""
        return cls()

    @classmethod
    def clip_g(cls) -> "CLIPTextConfig":
        """OpenCLIP bigG-14's text tower (SDXL's second encoder)."""
        return cls(width=1280, layers=32, heads=20, intermediate=5120,
                   act="gelu", projection_dim=1280)

    @classmethod
    def tiny(cls, **kw) -> "CLIPTextConfig":
        base = dict(vocab_size=128, max_len=16, width=32, layers=2, heads=2,
                    intermediate=64, eot_token_id=127)
        base.update(kw)
        return cls(**base)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(cfg.width, cfg.width))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.heads
        D = C // H
        q = self.q_proj(x).view(B, N, H, D)
        k = self.k_proj(x).view(B, N, H, D)
        v = self.v_proj(x).view(B, N, H, D)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (D ** 0.5) + mask
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, C)
        return self.out_proj(out)


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = (quick_gelu if cfg.act == "quick_gelu" else F.gelu)
        self.ln1 = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.attn = _CLIPAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.width, cfg.intermediate)
        self.fc2 = nn.Linear(cfg.intermediate, cfg.width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.fc2(self.act(self.fc1(self.ln2(x))))


class CLIPTextTransformer(nn.Module):
    """tokens [B, N] → {"last_hidden", "penultimate", "pooled"[,
    "projected"]}, fp32."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = cfg = config
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.width)
        self.pos_emb = nn.Parameter(torch.zeros(cfg.max_len, cfg.width))
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", _CLIPLayer(cfg))
        self.final_ln = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        if cfg.projection_dim:
            self.text_projection = nn.Linear(cfg.width, cfg.projection_dim,
                                             bias=False)

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """``pos_emb`` ~ normal(0.01), as the flax parameter."""
        self.pos_emb.normal_(0.0, 0.01, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.pos_emb.device

    def forward(self, tokens: torch.Tensor) -> dict[str, torch.Tensor]:
        cfg = self.config
        B, N = tokens.shape
        x = self.tok_emb(tokens) + self.pos_emb[None, :N]
        mask = torch.triu(torch.full((N, N), NEG_INF, device=x.device),
                          diagonal=1)
        penultimate = x
        for i in range(cfg.layers):
            if i == cfg.layers - 1:
                penultimate = x
            x = getattr(self, f"layer_{i}")(x, mask)
        last = self.final_ln(x)
        eot = torch.argmax((tokens == cfg.eot_token_id).int(), dim=1)
        pooled = last[torch.arange(B, device=last.device), eot]
        out = {"last_hidden": last, "penultimate": penultimate,
               "pooled": pooled}
        if cfg.projection_dim:
            out["projected"] = self.text_projection(pooled)
        return out


class SDXLTextStack(nn.Module):
    """SDXL's two encoders: ``encode_tokens(tokens_l, tokens_g)`` →
    context [B, 77, 2048] (both penultimates) and pooled [B, 1280] (G's
    projected EOT vector), as sgm's ``GeneralConditioner`` wires them."""

    def __init__(self, clip_l: CLIPTextTransformer,
                 clip_g: CLIPTextTransformer):
        super().__init__()
        if not clip_g.config.projection_dim:
            raise ValueError("CLIP-G needs a text_projection")
        self.clip_l = clip_l
        self.clip_g = clip_g

    @staticmethod
    def configs(tiny: bool = False) -> tuple[CLIPTextConfig, CLIPTextConfig]:
        if tiny:
            return (CLIPTextConfig.tiny(),
                    CLIPTextConfig.tiny(width=48, heads=2, act="gelu",
                                        projection_dim=48))
        return CLIPTextConfig.clip_l(), CLIPTextConfig.clip_g()

    @property
    def device(self) -> torch.device:
        return self.clip_l.device

    def encode_tokens(self, tokens_l: torch.Tensor, tokens_g: torch.Tensor):
        out_l = self.clip_l(tokens_l)
        out_g = self.clip_g(tokens_g)
        context = torch.cat([out_l["penultimate"], out_g["penultimate"]],
                            dim=-1)
        return context, out_g["projected"]


def validate_tokenizer_vocab(tok, cfg: CLIPTextConfig, name: str) -> None:
    """Refuse a ``CDT_TOKENIZER_DIR`` vocabulary that does not fit a
    tower: an id past the embedding table, or a wrong EOT id (which
    would pool position 0), would not fail loudly downstream."""
    if tok.eot_id != cfg.eot_token_id or len(tok.vocab) > cfg.vocab_size:
        raise ValueError(
            f"CDT_TOKENIZER_DIR vocab does not match the {name} tower: "
            f"vocab has {len(tok.vocab)} entries with EOT id {tok.eot_id}, "
            f"config expects vocab_size<={cfg.vocab_size} / "
            f"eot_token_id={cfg.eot_token_id}")


def tokenize_ids(texts: Sequence[str], tok, cfg: CLIPTextConfig,
                 pad_id: int) -> torch.Tensor:
    """Strings → [B, max_len] int64 ids on the host: BPE with a tokenizer,
    else the JAX package's deterministic hash fallback (SOT 0, then one
    blake2s id per word, EOT, padding), so that EOT pooling works."""
    if tok is not None:
        return torch.tensor([tok.encode(t) for t in texts], dtype=torch.long)

    def fallback(text: str) -> list[int]:
        ids = []
        for w in text.lower().split():
            h = hashlib.blake2s(w.encode(), digest_size=4).digest()
            ids.append(int.from_bytes(h, "little") % (cfg.vocab_size - 2) + 1)
        out = [0] + ids[: cfg.max_len - 2] + [cfg.eot_token_id]
        return out + [pad_id] * (cfg.max_len - len(out))
    return torch.tensor([fallback(t) for t in texts], dtype=torch.long)


class CLIPConditioner:
    """The CLIP input of the graph nodes (``CLIPTextEncode``) over the
    published stack: ``encode(texts)`` → (context, pooled) on the stack's
    device. ``kind`` is ``"sdxl"`` (an ``SDXLTextStack``) or ``"clip-l"``
    (one ``CLIPTextTransformer``; SD 1.5's convention: last hidden states
    and the EOT vector).

    Tokenizers come from ``CDT_TOKENIZER_DIR``; without a vocabulary the
    hash fallback keeps the stack runnable, but its conditioning does not
    reflect the prompt, and a warning says so."""

    def __init__(self, stack: nn.Module, kind: str = "sdxl",
                 tok_l: Optional[CLIPBPETokenizer] = None,
                 tok_g: Optional[CLIPBPETokenizer] = None):
        if kind not in ("sdxl", "clip-l"):
            raise ValueError(f"unknown CLIP stack kind {kind!r}")
        self.stack = stack
        self.kind = kind
        if kind == "sdxl" and (tok_l is None) != (tok_g is None):
            raise ValueError(
                "CLIPConditioner(kind='sdxl') needs both tok_l and tok_g "
                "(or neither, to load them from CDT_TOKENIZER_DIR); got "
                f"only {'tok_l' if tok_g is None else 'tok_g'}")
        if tok_l is None and tok_g is None:
            # each tower's own context length: the position tables cover
            # only config.max_len
            tok_l, _ = load_sd_tokenizers(max_len=self._cfg_l.max_len)
            if kind == "sdxl" and tok_l is not None:
                tok_g = CLIPBPETokenizer.from_env(
                    max_len=stack.clip_g.config.max_len, pad_token_id=0)
        self.tok_l, self.tok_g = tok_l, tok_g
        if tok_l is None:
            log("WARNING: no CLIP vocab at CDT_TOKENIZER_DIR: text is "
                "hash-tokenized; conditioning will not reflect the prompt")
            return
        validate_tokenizer_vocab(tok_l, self._cfg_l, "clip_l")
        if kind == "sdxl":
            validate_tokenizer_vocab(tok_g, stack.clip_g.config, "clip_g")

    @property
    def _cfg_l(self) -> CLIPTextConfig:
        return (self.stack.clip_l if self.kind == "sdxl" else self.stack).config

    def _towers(self) -> list:
        """(tokenizer, config, pad id) of each tower."""
        cfg_l = self._cfg_l
        towers = [(self.tok_l, cfg_l, cfg_l.eot_token_id)]
        if self.kind == "sdxl":
            towers.append((self.tok_g, self.stack.clip_g.config, 0))
        return towers

    def token_signature(self, texts) -> tuple[list, str]:
        """(token ids per tower, real-vs-hash mode): what a conditioning
        cache keys on, the mode included, so that a host without its
        vocabulary never shares entries with one that has it."""
        texts = [str(t) for t in texts]
        sig = [tokenize_ids(texts, tok, cfg, pad).tolist()
               for tok, cfg, pad in self._towers()]
        names = ("l", "g")
        mode = ",".join(f"{names[i]}={'bpe' if tok is not None else 'hash'}"
                        for i, (tok, _, _) in enumerate(self._towers()))
        return sig, mode

    @property
    def tokenization_mode(self) -> str:
        """"bpe" when every tower has a real tokenizer, else "hash"."""
        return ("bpe" if all(tok is not None for tok, _, _ in self._towers())
                else "hash")

    @torch.no_grad()
    def encode(self, texts) -> tuple[torch.Tensor, torch.Tensor]:
        texts = [str(t) for t in texts]
        device = self.stack.device
        for name, (tok, _, _) in zip(("clip_l", "clip_g"), self._towers()):
            if tok is None:
                count_hash_tokenization(name)
        ids = [tokenize_ids(texts, tok, cfg, pad).to(device)
               for tok, cfg, pad in self._towers()]
        if self.kind == "sdxl":
            return self.stack.encode_tokens(*ids)
        out = self.stack(ids[0])
        return out["last_hidden"], out["pooled"]
