"""The kernel census of mxnet_tpu_torch (``analysis/fusion.py``) against
the JAX package's fusion census.

- The products' FLOPs of a serving forward are the JAX census's, exactly:
  the small BERT encoder (the JAX program's attention products against
  the port's matrix products plus its ``flash_fwd`` node, which the JAX
  rule counts as those two products) and a small ResNet (convolutions).
  The JAX census reads each product's operand shapes from its HLO line
  where the printer writes them and from the producing op where it does
  not (``dataclasses.replace`` of the op, the JAX rule unchanged).
- The hand-written kernels' FLOP rules are the JAX ones at the same
  shapes: flash forward and backward, the recurrence, the norms, the
  bias-GELU pair and the update.
- Stranded chains, the baseline gate and the gauges.

Inputs are numpy-seeded; every comparison is exact.
"""
import dataclasses
import json
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.analysis import fusion as tfus
from mxnet_tpu_torch.analysis import schedule as tsched
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = os.path.join(ROOT, "tests", "fixtures",
                         "torch_fusion_baselines.json")


def _jax_product_flops(jpred, *args):
    """The JAX census's FLOPs of every dot and convolution of the
    predictor's optimized program."""
    from mxnet_tpu.analysis import fusion as jfus
    from mxnet_tpu.analysis.hlo import parse_hlo
    info = jpred.lower_entry(*args)
    mod = parse_hlo(info["lowered"].compile().as_text())

    def typed(op):
        return dataclasses.replace(op, operand_types=[
            mod.ops[o].type_str if o in mod.ops else None
            for o in op.operands])

    return sum(jfus.op_flops(typed(op), mod) for op in mod.ops.values()
               if op.opcode in ("dot", "convolution"))


def _port_product_flops(rep):
    return sum(k.flops for k in rep.fusion.kernels
               if k.kind in ("dot", "convolution")
               or k.name.endswith(" flash_fwd"))


def test_bert_encoder_product_flops_equal_jax(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "off")
    import mxnet_tpu as mx
    from mxnet_tpu.serving import CompiledPredictor as JPred
    from mxnet_tpu_torch.serving import CompiledPredictor as TPred
    from test_torch_zero import _bert_weights, _jax_bert
    tnet, weights = _bert_weights()
    jnet = _jax_bert(weights)
    x = onp.random.RandomState(0).randint(0, 100, (2, 8)).astype("int32")
    ref = _jax_product_flops(JPred(jnet, bucket_sizes=(2,)),
                             mx.nd.array(x, dtype="int32"))
    rep = TPred(tnet, bucket_sizes=(2,), device="cpu").analyze(
        torch.from_numpy(x.astype("int64")))
    assert _port_product_flops(rep) == ref
    (flash,) = {k.flops for k in rep.fusion.kernels
                if k.name.endswith(" flash_fwd")}
    assert flash == 4 * 2 * 2 * 8 * 8 * 16   # B H Sq Sk D


def test_resnet_convolution_flops_equal_jax():
    import mxnet_tpu as mx
    from mxnet_tpu.serving import CompiledPredictor as JPred
    from mxnet_tpu_torch.serving import CompiledPredictor as TPred
    from test_torch_vision import _images, _resnet_pair
    jnet, tnet, _ = _resnet_pair("resnet18_v1", 32, 2, classes=10,
                                 thumbnail=True)
    tnet.eval()
    x = _images(2, 32)
    ref = _jax_product_flops(JPred(jnet, bucket_sizes=(2,)), mx.nd.array(x))
    rep = TPred(tnet, bucket_sizes=(2,), device="cpu").analyze(
        torch.from_numpy(x))
    assert _port_product_flops(rep) == ref
    # the stem, 16 in the blocks, 3 downsampling shortcuts
    assert rep.fusion.by_kind()["convolution"] == 20 and ref > 0


def _jax_op(opcode_line, out_shape, operand_shapes):
    from mxnet_tpu.analysis.hlo import HloOp
    n = int(onp.prod(out_shape))
    return HloOp(name="k", opcode="custom-call",
                 type_str="f32[" + ",".join(map(str, out_shape)) + "]",
                 elements=n, dtype="f32", bytes=4 * n,
                 operands=[f"p{i}" for i in range(len(operand_shapes))],
                 line=opcode_line, custom_call_target="tpu_custom_call",
                 operand_types=["f32[" + ",".join(map(str, s)) + "]"
                                for s in operand_shapes])


def _port_node(name, out_shape, operand_shapes, **meta):
    def op(i, s):
        return tsched.Operand(i, tuple(s), "float32",
                              4 * int(onp.prod(s)))
    return tsched.Node(0, "kernel", name,
                       [op(i, s) for i, s in enumerate(operand_shapes)],
                       [op(99, out_shape)], meta=meta)


def _jax_rule(name):
    """The JAX package's FLOP rule of a kernel (``fusion.py:195-222``)."""
    from mxnet_tpu.analysis import fusion as jfus
    return {"flash_fwd": jfus._flash_fwd_flops,
            "flash_bwd_fused": jfus._flash_bwd_flops(10),
            "flash_bwd_dq": jfus._flash_bwd_flops(6),
            "flash_bwd_dkv": jfus._flash_bwd_flops(8),
            "rnn_scan_fwd": jfus._rnn_scan_flops,
            "rnn_scan_bwd": jfus._rnn_scan_flops,
            "layernorm_fwd": jfus._elementwise_flops(8),
            "layernorm_bwd": jfus._elementwise_flops(12),
            "bias_gelu_fwd": jfus._elementwise_flops(15),
            "bias_gelu_bwd": jfus._elementwise_flops(18),
            "opt_update": jfus._elementwise_flops(10)}[name]


# (port kernel, out shape, JAX operand shapes, the port's)
RULES = [
    ("flash_fwd", (6, 64, 32), [(6, 64, 32), (6, 48, 32), (6, 48, 32)],
     [(2, 3, 64, 32), (2, 3, 48, 32), (2, 3, 48, 32)]),
    ("flash_bwd_fused", (6, 64, 32), [(6, 64, 32), (6, 64, 32)],
     [(2, 3, 64, 32), (2, 3, 64, 32)]),
    ("flash_bwd_dq", (6, 64, 32), [(6, 64, 32), (6, 96, 32)],
     [(2, 3, 64, 32), (2, 3, 96, 32)]),
    ("flash_bwd_dkv", (6, 96, 32), [(6, 64, 32), (6, 96, 32)],
     [(2, 3, 64, 32), (2, 3, 96, 32)]),
    ("rnn_scan_fwd", (7, 5, 48), [(7, 5, 192), (192, 48)],
     [(7, 5, 192), (192, 48)]),
    ("rnn_scan_bwd", (7, 5, 192), [(7, 5, 192), (192, 48)],
     [(7, 5, 192), (192, 48)]),
    ("layernorm_fwd", (40, 96), [(40, 96), (96,), (96,)],
     [(40, 96), (96,), (96,)]),
    ("layernorm_bwd", (40, 96), [(40, 96), (96,), (40, 96)],
     [(40, 96), (96,), (40, 96)]),
    ("bias_gelu_fwd", (40, 96), [(40, 96), (96,)], [(40, 96), (96,)]),
    ("bias_gelu_bwd", (40, 96), [(40, 96), (96,), (40, 96)],
     [(40, 96), (96,), (40, 96)]),
    ("opt_update", (5000,), [(5000,), (5000,)], [(5000,)]),
]


@pytest.mark.parametrize("rule", RULES, ids=lambda r: r[0])
def test_kernel_flop_rules_equal_jax(rule):
    """Each hand-written kernel's node counts the JAX rule of its Pallas
    kernel at the same operand shapes (the port's flash operands are
    (B, H, S, D), the JAX ones (B*H, S, D); the update's is one launch
    over a list, its elements in ``meta``)."""
    name, out, jshapes, tshapes = rule
    meta = {"elements": 5000} if name == "opt_update" else {}
    ref = _jax_rule(name)(_jax_op("", out, jshapes))
    got = tfus.op_flops(_port_node(name, out, tshapes, **meta))
    assert got == ref and ref > 0


def test_jax_dispatch_shadows_the_norm_rules():
    """A divergence of the reference, kept out of the port: the JAX
    census matches a custom call's rule by substring in registration
    order, so ``_ln_fwd_kernel`` and ``_bg_fwd_kernel`` take the
    recurrence's ``_fwd_kernel`` rule (0 FLOPs at 2-d shapes) and
    ``_ln_bwd_kernel`` / ``_bg_bwd_kernel`` its ``_bwd_kernel`` one. The
    port keys each rule by its kernel's name."""
    from mxnet_tpu.analysis import fusion as jfus
    shapes = [(40, 96), (96,), (96,)]
    for match, name in (("_ln_fwd_kernel", "layernorm_fwd"),
                        ("_bg_bwd_kernel", "bias_gelu_bwd")):
        op = _jax_op(f'metadata={{op_name="{match}"}}', (40, 96), shapes)
        assert jfus.op_flops(op) == 0
        assert tfus.op_flops(_port_node(name, (40, 96), shapes)) == \
            _jax_rule(name)(op) > 0


def test_stranded_chain_between_two_products():
    rs = onp.random.RandomState(0)
    x = torch.from_numpy(rs.randn(64, 64).astype("f4"))
    w = torch.from_numpy(rs.randn(64, 64).astype("f4"))

    def body():
        h = x @ w
        h = torch.tanh(h * 2.0 + 1.0)      # three stranded ops
        return h @ w

    rec, _ = tsched.record(body)
    rep = tfus.fusion_census(rec)
    assert [s.opcode for s in sorted(rep.stranded, key=lambda s: s.name)] \
        == ["mul", "add", "tanh"]
    (chain,) = rep.stranded_chains()
    assert chain["n"] == 3 and chain["bytes"] == 3 * 64 * 64 * 4
    assert rep.by_kind() == {"dot": 2, "loop": 3}
    assert rep.total_flops == 2 * 2 * 64 ** 3 + 3 * 64 * 64
    assert rep.brief()["stranded_ops"] == 3
    assert all(f.rule == "stranded-op" for f in rep.findings)
    tfus.publish(rep)
    assert ttel.value(ttel.names.FUSION_STRANDED) == 3


def _small_bert_step():
    from test_torch_zero import _bert_weights
    tnet, weights = _bert_weights()
    load_jax_params(tnet, weights)
    tr = Trainer(dict(tnet.named_parameters()), "adam",
                 {"learning_rate": 1e-3})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(tnet(a), b))
    rs = onp.random.RandomState(1)
    x = torch.from_numpy(rs.randint(0, 100, (2, 8)))
    y = torch.from_numpy(rs.randint(0, 3, (2,)).astype("f4"))
    return step, x, y


def test_baseline_gate_checked_in_and_tight(tmp_path, monkeypatch):
    """The checked-in leg passes; a tight baseline gives error-severity
    ``fusion-regression`` findings, and MXNET_FUSION_BASELINE with
    ``analyze='raise'`` fails the first step."""
    step, x, y = _small_bert_step()
    fr = step.fusion_report(x, y)
    base = tfus.load_baselines(BASELINES)
    assert tfus.check_baseline(fr, base, "bert_small_train_cpu") == []
    tight = tmp_path / "tight.json"
    tight.write_text(json.dumps({"bert_small_train_cpu": dict(
        n_fusions=1, stranded_ops=0, boundary_bytes=1, tol_pct=0)}))
    bad = tfus.check_baseline(fr, tfus.load_baselines(str(tight)),
                              "bert_small_train_cpu")
    assert {f.rule for f in bad} == {"fusion-regression"} and len(bad) == 3
    assert all(f.severity == "error" for f in bad)
    (missing,) = tfus.check_baseline(fr, base, "no_such_leg")
    assert missing.severity == "warn"
    monkeypatch.setenv("MXNET_FUSION_BASELINE",
                       f"{tight}:bert_small_train_cpu")
    step2, x, y = _small_bert_step()
    step2._analyze = "raise"
    with pytest.raises(mxt.MXNetError, match="fusion-regression"):
        step2(x, y)
