"""How far float32 rounding carries on the convolutional path: the
measurements behind the bounds of ``tests/test_torch_vision.py`` and the
weights of ``chip_smoke.py``'s phase 14, on the CPU against float64.

    JAX_PLATFORMS=cpu python tests/vision_rounding.py [MEASURE ...]

Prints one JSON line a measurement (all four, or those named):

1. ``train``: three SGD-momentum steps of resnet18_v1 (thumbnail, 16 x
   16, batch 4; ``test_compile_step_matches_jax_trainloop``'s setup)
   through the JAX package's ``TrainLoop`` in float32 and in float64 and
   through the port's ``TrainLoop`` in float32: each run's largest loss
   and weight difference to the JAX float64 run.
2. ``resnet50_forward``: resnet50_v1 at 64 x 64, batch 2, in training and
   eval mode (``test_resnet_forward_matches_jax``'s setup): the JAX
   package's and the port's float32 logits against the port's float64
   ones, over the largest |logit|.
3. ``resnet50_gradients``: resnet50_v1 with ``chip_smoke.resnet_init``'s
   weights, and with gamma 1 in every BatchNorm instead, two
   training-mode backward passes at phase 14's gradient-check shape
   (4 x 64 x 64): the float32 gradients of the port computed with
   float32 accumulation (a card's arithmetic; the port's CPU
   convolutions accumulate in float64) against float64, worst parameter
   over phase 14's bound (1e-6 + 1e-3 x its largest gradient).
4. ``resnet50_trained_gradients``: the same check on resnet50_v1
   trained in float64 from those weights at phase 14's lr and momentum,
   after 1, 2, 3 and 10 steps: how far the conditioning of the trained
   net alone carries float32 rounding.
"""
import json
import os
import sys

import numpy as onp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def _max(a, b):
    return float(onp.abs(onp.asarray(a, onp.float64)
                         - onp.asarray(b, onp.float64)).max())


def train_gaps():
    import jax
    import test_torch_vision as T
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import TrainLoop as JTrainLoop
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JSCE
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon import loss as tloss

    def jax_run(dtype):
        jnet, tnet, _ = T._resnet_pair("resnet18_v1", T.TRAIN_SIZE,
                                       T.TRAIN_BATCH, dtype=dtype,
                                       **T.TRAIN_KW)
        loop = JTrainLoop(jnet, JTrainer(jnet.collect_params(), "sgd",
                                         dict(T.SGD)), JSCE())
        losses = [T._np(loop.step(T._jarr(x, dtype), T._jarr(y, dtype)))
                  for x, y in T._train_batches()]
        return losses, {k: T._np(p.data())
                        for k, p in jnet.collect_params().items()}, tnet

    jl32, jw32, _ = jax_run("float32")
    with jax.enable_x64(True):
        jl64, jw64, tnet = jax_run("float64")
    loop = TrainLoop(tnet, Trainer(dict(tnet.named_parameters()), "sgd",
                                   dict(T.SGD)),
                     tloss.SoftmaxCrossEntropyLoss())
    tl = [T._np(loop.step(torch.from_numpy(x), torch.from_numpy(y)))
          for x, y in T._train_batches()]
    tw = {k: T._np(p) for k, p in tnet.named_parameters()}
    return {
        "jax_float32": {"loss": [_max(a, b) for a, b in zip(jl32, jl64)],
                        "weights": max(_max(jw32[k], jw64[k])
                                       for k in jw64)},
        "port_float32": {"loss": [_max(a, b) for a, b in zip(tl, jl64)],
                         "weights": max(_max(tw[k], jw64[k])
                                        for k in jw64)}}


def resnet50_forward_gaps():
    import copy

    import test_torch_vision as T
    from mxnet_tpu import autograd as jautograd
    jnet, tnet, _ = T._resnet_pair("resnet50_v1", 64, 2)
    t64 = copy.deepcopy(tnet).double()
    out = {}
    for mode, seed in (("train", 12), ("eval", 13)):
        x = T._images(2, 64, seed=seed)
        if mode == "train":
            with jautograd.record():
                j = T._np(jnet(T._jarr(x)))
        else:
            tnet.eval()
            t64.eval()
            j = T._np(jnet(T._jarr(x)))
        t = T._np(tnet(torch.from_numpy(x)))
        f = t64(torch.from_numpy(x).double()).detach().numpy()
        scale = float(onp.abs(f).max())
        out[mode] = {"jax_float32": _max(j, f) / scale,
                     "port_float32": _max(t, f) / scale,
                     "jax_vs_port": _max(j, t) / scale,
                     "largest_logit": scale}
    return out


def _float32_vs_float64_grads(weights):
    """Phase 14's gradient check of a resnet50_v1 holding ``weights``
    ({name: float64 or float32 array}) on the CPU: two training-mode
    backward passes at its shape, the port's float32 gradients computed
    with float32 accumulation (a card's arithmetic; the port's CPU
    convolutions accumulate in float64) against float64's, each pass's
    [worst parameter, its error over phase 14's bound]."""
    import chip_smoke as cs
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import load_jax_params
    from mxnet_tpu_torch.ops import nn as tops

    def float32_conv(x, w, b=None, stride=None, dilate=None, pad=None,
                     num_group=1):
        nd = x.ndim - 2
        x, w, b = tops._promoted(x, w, b)
        return tops._CONV[nd](x, w, b, stride=tops._tup(stride, nd),
                              padding=tops._tup(pad or 0, nd),
                              dilation=tops._tup(dilate, nd),
                              groups=num_group)

    loss_fn = SoftmaxCrossEntropyLoss()
    nets = []
    for dtype, np_dtype in ((torch.float32, onp.float32),
                            (torch.float64, onp.float64)):
        net = resnet50_v1(device="cpu").to(dtype)
        load_jax_params(net, {k: onp.asarray(v, np_dtype)
                              for k, v in weights.items()})
        nets.append(net)
    rs = onp.random.RandomState(8)
    worst = []
    for _ in range(cs.RESNET_GRAD_STEPS):
        shape = (cs.RESNET_GRAD_BATCH, 3, cs.RESNET_GRAD_SIZE,
                 cs.RESNET_GRAD_SIZE)
        x = rs.uniform(size=shape).astype(onp.float32)
        y = rs.randint(0, 1000, (cs.RESNET_GRAD_BATCH,)).astype(onp.float32)
        shipped = tops.conv
        tops.conv = float32_conv
        try:
            g32 = cs.train_grads(torch, nets[0], loss_fn, x, y)
        finally:
            tops.conv = shipped
        g64 = cs.train_grads(torch, nets[1], loss_fn, x, y)
        r = cs.grad_check(torch, None, None, loss_fn, x, y, grads=(g32, g64))
        worst.append([r["worst_param"], r["worst_err_over_bound"]])
    return worst


def resnet50_gradient_conditioning():
    import chip_smoke as cs
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    init = cs.resnet_init(onp, resnet50_v1(device="cpu"), 6)
    return {name: _float32_vs_float64_grads(weights) for name, weights in (
        ("zero_last_gamma", init),
        ("gamma_1", {k: onp.ones_like(v) if k.endswith("gamma") else v
                     for k, v in init.items()}))}


def resnet50_trained_gradients():
    """Measure 4: resnet50_v1 from ``chip_smoke.resnet_init``'s weights
    trained in float64 on one repeated batch of TRAINED_BATCH images of
    TRAINED_SIZE pixels (seeded uniform, as phase 14 draws its batch of
    128 x 224 x 224) at phase 14's lr 0.1 and momentum 0.9, the loss's
    mean differentiated; after each of TRAINED_AT steps the check of
    :func:`_float32_vs_float64_grads` on the trained weights, and the
    step's loss."""
    import chip_smoke as cs
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import load_jax_params
    net = resnet50_v1(device="cpu")
    load_jax_params(net, cs.resnet_init(onp, net, 6))
    net.double().train()
    rs = onp.random.RandomState(7)
    x = torch.from_numpy(rs.uniform(size=(TRAINED_BATCH, 3, TRAINED_SIZE,
                                          TRAINED_SIZE))).double()
    y = torch.from_numpy(rs.randint(0, 1000, (TRAINED_BATCH,))).double()
    loss_fn = SoftmaxCrossEntropyLoss()
    params = [p for p in net.parameters()
              if getattr(p, "grad_req", "write") != "null"]
    moms = [torch.zeros_like(p) for p in params]
    out = {}
    for step in range(1, max(TRAINED_AT) + 1):
        loss = loss_fn(net(x), y).mean()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, m, g in zip(params, moms, grads):
                m.mul_(cs.RESNET_MOMENTUM).sub_(cs.RESNET_LR * g)
                p.add_(m)
        if step in TRAINED_AT:
            weights = {k: p.detach().numpy().copy()
                       for k, p in net.named_parameters()}
            out[step] = {"loss": float(loss),
                         "passes": _float32_vs_float64_grads(weights)}
    return {"batch": TRAINED_BATCH, "size": TRAINED_SIZE, "after": out}


#: measure 4's training shape (phase 14 trains at 128 x 224 x 224, which
#: this CPU run cannot hold) and the steps after which it checks
TRAINED_BATCH, TRAINED_SIZE, TRAINED_AT = 16, 64, (1, 2, 3, 10)


if __name__ == "__main__":
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    only = sys.argv[1:]
    for key, fn in (("train", train_gaps),
                    ("resnet50_forward", resnet50_forward_gaps),
                    ("resnet50_gradients", resnet50_gradient_conditioning),
                    ("resnet50_trained_gradients",
                     resnet50_trained_gradients)):
        if not only or key in only:
            print(json.dumps({key: fn()}), flush=True)
