"""DistilBERT, the Frozen-in-Time text tower, in PyTorch: port of
``fitclip_tpu/models/frozen_in_time/distilbert.py``.

Word + position embeddings with LayerNorm (eps 1e-12), then post-LN blocks
with separate q/k/v/out projections, keys masked where the mask is 0 (with
finfo(float32).min), fp32 softmax and an exact-GELU FFN. Module names mirror
the JAX tree (``layers.2.attention_q_lin`` is ``layer_2/attention_q_lin``).
No TPU kernel serves this tower: its denses and attention stay plain PyTorch
(cuBLAS on the card).
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fitclip_torch.models.clip.model import Dense, LayerNormFp32

LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    hidden_dim: int = 3072
    n_layers: int = 6
    n_heads: int = 12
    max_position_embeddings: int = 512

    @staticmethod
    def tiny_test(vocab_size: int = 100) -> "DistilBertConfig":
        return DistilBertConfig(vocab_size=vocab_size, dim=32, hidden_dim=64, n_layers=2,
                                n_heads=4, max_position_embeddings=32)


class TransformerBlock(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d, hidden = config.dim, config.hidden_dim
        self.heads = config.n_heads
        self.attention_q_lin = Dense(d, d, dtype, device)
        self.attention_k_lin = Dense(d, d, dtype, device)
        self.attention_v_lin = Dense(d, d, dtype, device)
        self.attention_out_lin = Dense(d, d, dtype, device)
        self.sa_layer_norm = LayerNormFp32(d, dtype, LN_EPS, device)
        self.ffn_lin1 = Dense(d, hidden, dtype, device)
        self.ffn_lin2 = Dense(hidden, d, dtype, device)
        self.output_layer_norm = LayerNormFp32(d, dtype, LN_EPS, device)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        b, seq, width = x.shape
        head_dim = width // self.heads

        def heads(t):
            return t.reshape(b, seq, self.heads, head_dim).transpose(1, 2).float()

        q, k = heads(self.attention_q_lin(x)), heads(self.attention_k_lin(x))
        v = self.attention_v_lin(x)
        logits = (q @ k.transpose(-1, -2)) / head_dim ** 0.5
        keep = (attention_mask > 0)[:, None, None, :]
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(x.dtype).float()
        attn = (weights @ heads(v)).transpose(1, 2).reshape(b, seq, width).to(x.dtype)
        x = self.sa_layer_norm(x + self.attention_out_lin(attn))
        h = self.ffn_lin2(F.gelu(self.ffn_lin1(x)))
        return self.output_layer_norm(x + h)


class DistilBertModel(nn.Module):
    """(B, L) ids and (B, L) mask -> (B, L, dim) last hidden state in ``dtype``
    (LayerNorm statistics and softmax fp32 whatever the dtype)."""

    def __init__(self, config: DistilBertConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.word_embeddings = nn.Parameter(torch.zeros(config.vocab_size, config.dim,
                                                        device=device))
        self.position_embeddings = nn.Parameter(
            torch.zeros(config.max_position_embeddings, config.dim, device=device))
        self.embeddings_layer_norm = LayerNormFp32(config.dim, dtype, LN_EPS, device)
        self.layers = nn.ModuleList(TransformerBlock(config, dtype, device)
                                    for _ in range(config.n_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.word_embeddings[input_ids] + self.position_embeddings[:input_ids.shape[1]]
        x = self.embeddings_layer_norm(x)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x
