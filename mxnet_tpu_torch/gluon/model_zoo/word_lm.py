"""The LSTM word language model (counterpart of ``WordLM`` in the JAX
package's ``examples/train_lstm_lm.py``, the reference's
example/rnn/word_lm): Embedding → ``rnn.LSTM(layout="NTC")`` →
``Dense(vocab, flatten=False)``.

Children are ``emb``, ``lstm`` and ``head``, so the parameter names are
the JAX block's (``emb.weight``, ``lstm.l0_i2h_weight``, ...,
``head.weight``, ``head.bias``) and a dict of its ``collect_params()``
loads with ``gluon.params.load_jax_params``. The JAX package's LSTM
benchmark runs it at vocab 33,278 (wikitext-2), embed and hidden 650,
2 layers, batch 64 x bptt 35.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...context import resolve_device
from ..nn.basic_layers import Dense, Embedding
from ..rnn import LSTM

__all__ = ["WordLM"]


class WordLM(nn.Module):
    def __init__(self, vocab: int, embed: int, hidden: int, layers: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.emb = Embedding(vocab, embed, **kw)
        self.lstm = LSTM(hidden, num_layers=layers, layout="NTC",
                         input_size=embed, **kw)
        self.head = Dense(vocab, flatten=False, in_units=hidden, **kw)

    def forward(self, tokens):
        """tokens (N, T) → logits (N, T, vocab)."""
        return self.head(self.lstm(self.emb(tokens)))
