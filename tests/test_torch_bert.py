"""mxnet_tpu_torch BERT and transformer layers against the JAX package.

One seeded numpy dict (``init_params_numpy``) feeds both packages: the
JAX ``collect_params()`` ``set_data`` and the port's ``load_jax_params``.
Tolerance: 2e-5 absolute and relative, float32 against float32 through a
small whole model (each op agrees to ~1e-7; observed differences are
~1e-8).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.nn import transformer as jtr

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.nn import transformer as ttr
from mxnet_tpu_torch.gluon.params import init_params_numpy, load_jax_params

TOL = 2e-5
SEQ = 10


def _pair(make_jax, make_torch, example, seed=0):
    """The same seeded weights in a JAX block and a port module."""
    tnet = make_torch().eval()
    params = init_params_numpy(tnet, seed)
    load_jax_params(tnet, params)
    jnet = make_jax()
    jnet.initialize()
    jnet(*example)
    jp = jnet.collect_params()
    assert sorted(jp.keys()) == sorted(params)
    for k, p in jp.items():
        p.set_data(mx.nd.array(params[k]))
    return jnet, tnet


def _tokens(n=3, seed=1, vocab=128):
    return onp.random.RandomState(seed).randint(0, vocab, (n, SEQ)) \
        .astype("int32")


def _np(out):
    return out.asnumpy() if hasattr(out, "asnumpy") else out.numpy()


def _jx(x):
    return mx.nd.array(x, dtype=str(x.dtype))


def _close(a, b):
    onp.testing.assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def classifier_pair():
    x = _tokens()
    return _pair(
        lambda: jbert.BERTClassifier(jbert.bert_small_test(), num_classes=3),
        lambda: tbert.BERTClassifier(tbert.bert_small_test(device="cpu"),
                                     num_classes=3, device="cpu"),
        (_jx(x),))


@pytest.mark.parametrize("with_vl", [False, True])
def test_classifier_logits_vs_jax(classifier_pair, with_vl):
    jnet, tnet = classifier_pair
    x = _tokens(seed=2)
    vl = onp.array([SEQ, 4, 1], "int32")
    tt = onp.random.RandomState(3).randint(0, 2, x.shape).astype("int32")
    jargs = (_jx(x), _jx(tt)) + ((_jx(vl),) if with_vl else ())
    with torch.inference_mode():
        targs = (torch.from_numpy(x), torch.from_numpy(tt)) + \
            ((torch.from_numpy(vl),) if with_vl else ())
        _close(jnet(*jargs), tnet(*targs))


def test_parameter_names_match_jax(classifier_pair):
    jnet, tnet = classifier_pair
    names = [n for n, _ in tnet.named_parameters()]
    assert names == list(jnet.collect_params().keys())
    assert len(names) == 41
    assert "bert.encoder.layer0.attention.query_proj.weight" in names
    assert "bert.embed_ln.gamma" in names and "classifier.bias" in names


@pytest.mark.parametrize("with_vl", [False, True])
@pytest.mark.parametrize("use_decoder", [False, True])
def test_bert_model_outputs_vs_jax(with_vl, use_decoder):
    x = _tokens(seed=4)
    jnet, tnet = _pair(
        lambda: jbert.bert_small_test(use_decoder=use_decoder),
        lambda: tbert.bert_small_test(use_decoder=use_decoder, device="cpu"),
        (_jx(x),), seed=5)
    vl = onp.array([SEQ, 3, 6], "int32")
    jout = jnet(_jx(x), None, _jx(vl) if with_vl else None)
    with torch.inference_mode():
        tout = tnet(torch.from_numpy(x), None,
                    torch.from_numpy(vl) if with_vl else None)
    assert len(jout) == len(tout) == (3 if use_decoder else 2)
    for a, b in zip(jout, tout):     # sequence, pooled[, MLM scores]
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


def test_bert_base_parameter_count_and_names():
    net = tbert.bert_base(device="cpu")
    names = [n for n, _ in net.named_parameters()]
    jnames = list(jbert.bert_base().collect_params().keys())
    assert names == jnames and len(names) == 199
    clf = tbert.BERTClassifier(net, num_classes=2, device="cpu")
    assert len(list(clf.named_parameters())) == 201
    assert sum(p.numel() for p in clf.parameters()) == 109_483_778


@pytest.mark.parametrize("activation", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("mode", ["on", "off"])
def test_transformer_encoder_vs_jax(monkeypatch, activation, mode):
    # "gelu" runs the bias-GELU path on both sides (the JAX kernel in
    # interpret mode under MXNET_PALLAS=on)
    monkeypatch.setenv("MXNET_PALLAS", mode)
    x = onp.random.RandomState(6).randn(2, 9, 32).astype("f4")
    jnet, tnet = _pair(
        lambda: jtr.TransformerEncoder(2, 32, 64, 4, activation=activation),
        lambda: ttr.TransformerEncoder(2, 32, 64, 4, activation=activation,
                                       device="cpu"),
        (mx.nd.array(x),), seed=7)
    with torch.inference_mode():
        _close(jnet(mx.nd.array(x)), tnet(torch.from_numpy(x)))


def test_ffn_gelu_takes_bias_gelu(monkeypatch):
    calls = []
    real = ttr.bias_gelu
    monkeypatch.setattr(ttr, "bias_gelu",
                        lambda *a: calls.append(1) or real(*a))
    ffn = ttr.PositionwiseFFN(8, 16, device="cpu").eval()
    with torch.inference_mode():
        ffn(torch.ones(2, 3, 8))
    assert calls == [1]
    ffn2 = ttr.PositionwiseFFN(8, 16, activation="gelu_tanh",
                               device="cpu").eval()
    with torch.inference_mode():
        ffn2(torch.ones(2, 3, 8))
    assert calls == [1]


def test_attention_with_mask_vs_jax():
    x = onp.random.RandomState(8).randn(2, 6, 16).astype("f4")
    mask = onp.where(onp.tril(onp.ones((6, 6))) > 0, 0.0, -1e9) \
        .astype("f4")[None, None]
    vl = onp.array([6, 4], "int32")
    jnet, tnet = _pair(
        lambda: jtr.MultiHeadAttention(16, 4),
        lambda: ttr.MultiHeadAttention(16, 4, device="cpu"),
        (mx.nd.array(x),), seed=9)
    with torch.inference_mode():
        _close(jnet(mx.nd.array(x), mask=mx.nd.array(mask),
                    valid_length=_jx(vl)),
               tnet(torch.from_numpy(x), mask=torch.from_numpy(mask),
                    valid_length=torch.from_numpy(vl)))


def test_load_jax_params_rejects_bad_dicts():
    net = tbert.bert_small_test(device="cpu")
    good = init_params_numpy(net, 0)
    missing = dict(good)
    missing.pop("embed_ln.gamma")
    with pytest.raises(mxt.MXNetError, match="missing keys"):
        load_jax_params(net, missing)
    with pytest.raises(mxt.MXNetError, match="unexpected keys"):
        load_jax_params(net, dict(good, extra=onp.zeros(1, "f4")))
    bad = dict(good)
    bad["word_embed.weight"] = onp.zeros((3, 3), "f4")
    with pytest.raises(mxt.MXNetError, match="has shape"):
        load_jax_params(net, bad)


def test_init_params_numpy_is_seeded():
    net = tbert.bert_small_test(device="cpu")
    a, b = init_params_numpy(net, 3), init_params_numpy(net, 3)
    assert all((a[k] == b[k]).all() for k in a)
    assert (a["embed_ln.gamma"] == 1).all()
    assert (a["embed_ln.beta"] == 0).all()
    w = a["encoder.layer0.ffn.ffn_1.weight"]
    assert w.dtype == onp.float32 and 0.015 < w.std() < 0.025
    assert not (init_params_numpy(net, 4)["word_embed.weight"]
                == a["word_embed.weight"]).all()


def test_builders_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        tbert.bert_small_test()
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        ttr.TransformerEncoder(1, 8, 16, 2)
    tbert.bert_small_test(device="cpu")     # the CPU when asked for


def test_sequence_too_long_raises():
    net = tbert.bert_small_test(device="cpu")
    with pytest.raises(mxt.MXNetError, match="max_length"):
        net(torch.zeros(1, 65, dtype=torch.long))
