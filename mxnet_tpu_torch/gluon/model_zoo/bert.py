"""BERT model family (counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``).

Same configurations, defaults and parameter names as the JAX package.
Every builder runs on ``cuda:0`` unless ``device="cpu"`` is passed, and
raises without CUDA otherwise. Weights are random; a dict of the JAX
package's ``collect_params()`` (or of ``gluon.params.init_params_numpy``)
loads with ``gluon.params.load_jax_params``.

Training: every parameter is trainable and the forward is
differentiable through the flash-attention and LayerNorm kernels. In
``train()`` mode (a module's default) dropout is on; ``eval()`` turns it
off. The masked-LM decoder's output projection reuses
``word_embed.weight``, which so gets the gradient of the lookup and of
the projection, summed.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as FNN
from ...ops.registry import invoke
from ..nn.basic_layers import Dense, Dropout, Embedding, LayerNorm, \
    activation
from ..nn.transformer import TransformerEncoder

__all__ = ["BERTModel", "BERTClassifier", "bert_base", "bert_large",
           "bert_small_test"]


class BERTModel(nn.Module):
    """BERT encoder: token + position + segment embeddings → transformer
    stack → (sequence output, pooled [CLS] output [, masked-LM scores])."""

    def __init__(self, vocab_size: int = 30522, units: int = 768,
                 hidden_size: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, max_length: int = 512,
                 token_type_vocab_size: int = 2, dropout: float = 0.1,
                 use_pooler: bool = True, use_decoder: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self._units = units
        self._max_length = max_length
        self.word_embed = Embedding(vocab_size, units, **kw)
        self.token_type_embed = Embedding(token_type_vocab_size, units, **kw)
        self.position_embed = Embedding(max_length, units, **kw)
        self.embed_ln = LayerNorm(in_channels=units, device=dev)
        self.embed_dropout = Dropout(dropout, generator=generator)
        # gelu_tanh: the tanh-polynomial GELU of the original BERT code
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout=dropout,
                                          activation="gelu_tanh", **kw)
        self.pooler = Dense(units, activation="tanh", flatten=False,
                            in_units=units, **kw) if use_pooler else None
        if use_decoder:
            self.decoder_transform = Dense(units, flatten=False,
                                           in_units=units, **kw)
            self.decoder_ln = LayerNorm(in_channels=units, device=dev)
            # the output projection ties to word_embed.weight
        else:
            self.decoder_transform = None

    def forward(self, inputs, token_types=None, valid_length=None):
        b, s = inputs.shape
        if s > self._max_length:
            raise MXNetError(f"sequence length {s} exceeds max_length "
                             f"{self._max_length}")
        pos = torch.arange(s, device=inputs.device)
        x = self.word_embed(inputs)
        x = x + self.position_embed(pos).reshape(1, s, self._units)
        if token_types is None:
            token_types = torch.zeros_like(inputs)
        x = x + self.token_type_embed(token_types)
        x = self.embed_dropout(self.embed_ln(x))
        seq = self.encoder(x, valid_length=valid_length)
        outs = [seq]
        if self.pooler is not None:
            outs.append(self.pooler(seq[:, 0]))
        if self.decoder_transform is not None:
            h = self.decoder_ln(activation(self.decoder_transform(seq),
                                           "gelu"))
            outs.append(invoke("bert_decoder_proj", FNN.linear, h,
                               self.word_embed.weight))
        return outs[0] if len(outs) == 1 else tuple(outs)


class BERTClassifier(nn.Module):
    """BERT + dropout + dense head over the pooled output."""

    def __init__(self, bert: BERTModel, num_classes: int = 2,
                 dropout: float = 0.1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if bert.pooler is None:
            raise MXNetError("BERTClassifier requires a BERTModel built "
                             "with use_pooler=True")
        dev = resolve_device(device)
        self.bert = bert.to(dev)
        self.dropout = Dropout(dropout, generator=generator)
        self.classifier = Dense(num_classes, in_units=bert._units,
                                device=dev, generator=generator)

    def forward(self, inputs, token_types=None, valid_length=None):
        out = self.bert(inputs, token_types, valid_length)
        return self.classifier(self.dropout(out[1]))


def bert_base(**kwargs):
    """BERT-base: 12 layers, 768 units, 12 heads (110M params)."""
    return BERTModel(units=768, hidden_size=3072, num_layers=12,
                     num_heads=12, **kwargs)


def bert_large(**kwargs):
    """BERT-large: 24 layers, 1024 units, 16 heads (340M params)."""
    return BERTModel(units=1024, hidden_size=4096, num_layers=24,
                     num_heads=16, **kwargs)


def bert_small_test(**kwargs):
    """Tiny config for tests."""
    kwargs.setdefault("vocab_size", 128)
    kwargs.setdefault("max_length", 64)
    return BERTModel(units=32, hidden_size=64, num_layers=2, num_heads=4,
                     **kwargs)
