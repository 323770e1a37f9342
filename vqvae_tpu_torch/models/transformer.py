"""Decoder-only transformer prior over code sequences — the port of
``vqvae_tpu/models/transformer.py``.

GPT-style: learned positional embeddings, optional class conditioning (a
class embedding added at every position), pre-LN blocks, causal
multi-head attention, a 4x GELU MLP, a bias-free output head, N(0, 0.02)
init for dense and embedding weights, zero biases. Sampling uses a KV
cache that spans ``max_seq_len`` (``Transformer.init_cache``; a forward
given the cache is one decode step), masked to the positions written.

The arithmetic follows flax's modules, op by op:

- ``LayerNorm``: epsilon 1e-6 and flax's fast variance
  ``max(E[x^2] - E[x]^2, 0)``, then ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias``;
- attention (flax ``MultiHeadDotProductAttention``): q, k, v projections
  to (heads, head_dim), the query divided by sqrt(head_dim) before the
  product, masked logits set to ``finfo(float32).min`` (not -inf),
  softmax, dropout on the weights with one (T, T) mask shared by the batch
  and the heads, the weighted sum and the output projection;
- GELU is the tanh approximation (flax's ``nn.gelu`` default);
- dropout keeps with probability 1 - rate and scales by 1 / (1 - rate),
  on the embeddings, the attention weights, after attention and after the
  MLP, drawn from an explicit ``torch.Generator``.

``dtype`` (flax's): the parameters stay float32; the embeddings are cast
to ``dtype``, every dense layer computes in it (``models/cast.py``), the
residual stream stays in it, the LayerNorms normalize in float32 and
return it, and attention follows flax's ``dot_product_attention_weights``:
the query divided by sqrt(head_dim) rounded to ``dtype``, the logits in
``dtype``, masked to ``finfo(dtype).min``, and the softmax computed in
``dtype`` op by op (max, exp, sum, divide). The logits come back float32.

Parameters use torch's layouts (``nn.Linear`` weights are (out, in));
``utils.checkpoint.transformer_state_dict_from_jax`` carries flax's
params across.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import global_value
from .cast import Linear, resolve_dtype, set_compute_dtype

_INIT_STD = 0.02
LN_EPS = 1e-6
_NEG = torch.finfo(torch.float32).min


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shape=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    its inverse; ``shape`` (broadcast against ``x``) shares one mask.
    Identity when ``generator`` is None or ``rate`` is 0."""
    if generator is None or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(shape if shape is not None else x.shape,
                      generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), device=x.device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (the tanh approximation). In half precision it
    runs op by op in the input's dtype with the constants rounded to it,
    as XLA evaluates ``jax.nn.gelu`` there."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")

    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6, fast variance); a half
    precision input is normalized in float32 and the result cast back."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return self.forward(x.float()).to(x.dtype)
        mu = x.mean(-1, keepdim=True)
        mu2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


@dataclass
class KVCache:
    """Per-layer keys and values, (B, max_seq_len, heads, head_dim), and
    the position the next decode step writes."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    index: int = 0


class Attention(nn.Module):
    def __init__(self, embed_dim: int, n_head: int, dropout: float):
        super().__init__()
        if embed_dim % n_head:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"n_head {n_head}")
        self.n_head, self.head_dim = n_head, embed_dim // n_head
        self.dropout = dropout
        self.query = Linear(embed_dim, embed_dim)
        self.key = Linear(embed_dim, embed_dim)
        self.value = Linear(embed_dim, embed_dim)
        self.out = Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                cache: Optional[KVCache] = None, layer: int = 0
                ) -> torch.Tensor:
        b, t, d = x.shape
        shape = (b, t, self.n_head, self.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        if cache is not None:  # one position, at cache.index
            i = cache.index
            cache.keys[layer][:, i] = k[:, 0]
            cache.values[layer][:, i] = v[:, 0]
            k, v = cache.keys[layer], cache.values[layer]
            mask = (torch.arange(k.shape[1], device=x.device)
                    <= i).view(1, 1, 1, -1)
        if q.dtype == torch.float32:
            q = q / math.sqrt(self.head_dim)
        else:  # flax divides by sqrt(depth) rounded to the dtype
            q = q / torch.tensor(math.sqrt(self.head_dim), dtype=q.dtype)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            neg = _NEG if w.dtype == torch.float32 else \
                torch.finfo(w.dtype).min
            w = torch.where(mask, w, torch.full((), neg, dtype=w.dtype,
                                                device=x.device))
        if w.dtype == torch.float32:
            w = torch.softmax(w, dim=-1)
        else:  # jax.nn.softmax in the dtype, op by op
            e = torch.exp(w - w.amax(dim=-1, keepdim=True))
            w = e / e.sum(dim=-1, keepdim=True)
        w = dropout(w, self.dropout, generator, (1, 1) + w.shape[-2:])
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d)
        return self.out(o)


class Block(nn.Module):
    def __init__(self, embed_dim: int, n_head: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.ln1 = LayerNorm(embed_dim)
        self.attn = Attention(embed_dim, n_head, dropout)
        self.ln2 = LayerNorm(embed_dim)
        self.fc1 = Linear(embed_dim, 4 * embed_dim)
        self.fc2 = Linear(4 * embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                cache: Optional[KVCache] = None, layer: int = 0
                ) -> torch.Tensor:
        h = self.attn(self.ln1(x), mask, generator, cache, layer)
        x = x + dropout(h, self.dropout, generator)
        h = self.fc2(gelu(self.fc1(self.ln2(x))))
        return x + dropout(h, self.dropout, generator)


class Transformer(nn.Module):
    def __init__(self, num_classes: int = 0, num_tokens: int = 512,
                 embed_dim: int = 256, n_layers: int = 4, n_head: int = 4,
                 max_seq_len: int = 16, dropout: float = 0.1,
                 dtype="float32"):
        super().__init__()
        self.num_classes = int(num_classes)
        self.num_tokens = int(num_tokens)
        self.embed_dim = int(embed_dim)
        self.n_head = int(n_head)
        self.max_seq_len = int(max_seq_len)
        self.dropout = float(dropout)
        self.token_emb = nn.Embedding(num_tokens, embed_dim)
        self.pos_emb = nn.Parameter(torch.zeros(1, max_seq_len, embed_dim))
        self.class_emb = (nn.Embedding(num_classes, embed_dim)
                          if num_classes > 0 else None)
        self.blocks = nn.ModuleList(Block(embed_dim, n_head, dropout)
                                    for _ in range(n_layers))
        self.ln_f = LayerNorm(embed_dim)
        self.head = Linear(embed_dim, num_tokens, bias=False)
        self.compute_dtype = resolve_dtype(dtype)
        set_compute_dtype(self, dtype)

    def forward(self, idx: torch.Tensor, y: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        """Logits (B, T, num_tokens) of ``idx`` (B, T) int token ids.
        ``generator`` turns dropout on (training); ``cache`` makes this a
        decode step at position ``cache.index``, which it advances."""
        b, t = idx.shape
        start = cache.index if cache is not None else 0
        if cache is not None and t != 1:
            raise ValueError(f"a decode step takes one token a row, got {t}")
        if start + t > self.max_seq_len:
            raise ValueError(f"seq len {start + t} > max {self.max_seq_len}")
        dt = self.compute_dtype
        x = (self.token_emb(idx).to(dt)
             + self.pos_emb[:, start:start + t].to(dt))
        x = dropout(x, self.dropout, generator)
        if self.class_emb is not None and y is not None:
            x = x + self.class_emb(y)[:, None, :].to(dt)
        mask = None
        if cache is None:
            pos = torch.arange(t, device=idx.device)
            mask = (pos[:, None] >= pos[None, :]).view(1, 1, t, t)
        for i, block in enumerate(self.blocks):
            x = block(x, mask, generator, cache, i)
        if cache is not None:
            cache.index += t
        return self.head(self.ln_f(x)).float()

    def init_cache(self, batch_size: int) -> KVCache:
        """An empty KV cache on the model's device."""
        dev, dt = self.pos_emb.device, self.compute_dtype
        shape = (batch_size, self.max_seq_len, self.n_head,
                 self.embed_dim // self.n_head)
        return KVCache(
            [torch.zeros(shape, dtype=dt, device=dev) for _ in self.blocks],
            [torch.zeros(shape, dtype=dt, device=dev) for _ in self.blocks])


@torch.no_grad()
def transformer_init_(model: Transformer,
                      generator: torch.Generator) -> Transformer:
    """flax's initialisation: N(0, 0.02) for every dense kernel, embedding
    and the positional table; zero biases; LayerNorm scale 1, bias 0. The
    draws come from ``generator`` (a CPU generator gives every device the
    same weights)."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.copy_(torch.randn(module.weight.shape,
                                            generator=generator) * _INIT_STD)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    model.pos_emb.copy_(torch.randn(model.pos_emb.shape,
                                    generator=generator) * _INIT_STD)
    return model


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       label_smoothing: float = 0.0,
                       mesh=None) -> torch.Tensor:
    """Token-averaged cross entropy; ``mask`` (B,) weights whole rows and
    the sum is divided by ``max(sum of weights, 1)``. Label smoothing mixes
    in ``-mean(log p)`` over the vocabulary. The sum and the token count
    are the global batch's of ``mesh`` (``parallel.global_value``; None:
    this batch's)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    w = (mask[:, None] * torch.ones_like(nll) if mask is not None
         else torch.ones_like(nll))
    num, den = global_value(torch.stack([(nll * w).sum(), w.sum()]), mesh)
    return num / (torch.clamp_min(den, 1.0) if mask is not None else den)
