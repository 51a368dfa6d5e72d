"""Import boundary of the PyTorch/CUDA port.

``mxnet_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
package, and the package never calls a library kernel in place of its
own (``scaled_dot_product_attention``, ``F.layer_norm`` /
``torch.layer_norm``, ``torch.compile``, cuDNN's recurrence:
``torch.nn.LSTM`` / ``GRU`` / ``RNN``, ``torch._VF``, ``torch.lstm``, and
the library's optimizer kernels: ``torch.optim``, ``torch._fused_adam_``
and its kin, ``torch._foreach_*``).
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")


def _package_files():
    out = []
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden_module(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def test_package_has_its_modules():
    rel = {os.path.relpath(p, ROOT) for p in _package_files()}
    for m in ("base.py", "context.py", "ops/kernels/__init__.py",
              "ops/kernels/norm.py", "ops/attention.py", "ops/nn.py",
              "gluon/nn/basic_layers.py", "gluon/nn/transformer.py",
              "gluon/model_zoo/bert.py", "gluon/params.py",
              "serving/predictor.py", "serving/batcher.py",
              "serving/loadgen.py", "gluon/loss.py", "gluon/trainer.py",
              "gluon/fused_step.py", "lr_scheduler.py",
              "optimizer/optimizer.py", "ops/rnn.py",
              "ops/kernels/rnn_scan.py", "gluon/rnn/rnn_layer.py",
              "gluon/model_zoo/word_lm.py", "engine.py",
              "serving/resilience.py", "serving/kvcache.py",
              "serving/decode.py", "gluon/gqa_decoder.py",
              "parallel/dist.py", "parallel/mesh.py",
              "parallel/collectives.py", "parallel/compression.py",
              "kvstore/base.py",
              "kvstore/kvstore.py", "ops/kernels/opt_update.py",
              "amp/__init__.py", "amp/loss_scaler.py", "ops/registry.py",
              "testing/__init__.py", "testing/faults.py",
              "ndarray/__init__.py", "ndarray/utils.py",
              "checkpoint/__init__.py", "checkpoint/atomic.py",
              "checkpoint/state.py", "checkpoint/manager.py",
              "gluon/block.py", "elastic/__init__.py", "elastic/detect.py",
              "elastic/supervisor.py", "gluon/data/__init__.py",
              "gluon/data/prefetcher.py", "captured.py",
              "serving/captured.py", "ndarray/ops.py",
              "gluon/rnn/rnn_cell.py", "gluon/contrib/__init__.py",
              "gluon/contrib/rnn/__init__.py",
              "gluon/contrib/rnn/rnn_cell.py",
              "gluon/contrib/rnn/conv_rnn_cell.py",
              "gluon/contrib/nn/__init__.py",
              "gluon/contrib/nn/basic_layers.py",
              "gluon/contrib/estimator/__init__.py",
              "gluon/contrib/estimator/estimator.py", "serving/fleet.py",
              "telemetry/__init__.py", "telemetry/names.py",
              "telemetry/registry.py", "telemetry/timeline.py",
              "telemetry/watchdog.py", "telemetry/exporters.py",
              "telemetry/memory.py", "telemetry/numerics.py",
              "profiler.py", "inspector.py",
              "gluon/contrib/estimator/event_handler.py", "recordio.py",
              "host.py", "gluon/data/dataset.py", "gluon/data/sampler.py",
              "gluon/data/batchify.py", "gluon/data/dataloader.py",
              "gluon/utils.py", "image/__init__.py", "image/image.py",
              "gluon/data/vision/__init__.py",
              "gluon/data/vision/transforms.py",
              "gluon/data/vision/datasets.py", "io/__init__.py",
              "io/io.py", "tuning/__init__.py", "tuning/space.py",
              "tuning/search.py", "tuning/cache.py", "tuning/measure.py",
              "analysis/__init__.py", "analysis/report.py",
              "analysis/guard.py", "analysis/threads.py",
              "analysis/lint.py", "analysis/schedule.py",
              "analysis/program.py", "analysis/fusion.py",
              "analysis/sharding.py", "analysis/overlap.py",
              "testing/sched.py"):
        assert os.path.join("mxnet_tpu_torch", m) in rel, m
    csrc = os.listdir(os.path.join(PKG, "ops", "kernels", "csrc"))
    assert {"flash_fwd.cu", "layernorm_fwd.cu", "bias_gelu_fwd.cu",
            "flash_bwd.cu", "layernorm_bwd.cu", "bias_gelu_bwd.cu",
            "rnn_scan_fwd.cu", "rnn_scan_bwd.cu",
            "rnn_decode.cu", "opt_update.cu"} <= set(csrc)


@pytest.mark.parametrize("path", _package_files()
                         + [os.path.join(ROOT, "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [(line, name) for line, name in _imports(_parse(path))
           if _forbidden_module(name)]
    assert not bad, f"{path} imports {bad}"


def _lower_layer_files():
    """The kernel layer, the ops and the collectives: below analysis/."""
    return [p for p in _package_files()
            if os.path.relpath(p, PKG).split(os.sep)[0] in ("ops",
                                                            "parallel")]


def _imports_analysis(tree, path) -> list:
    """The imports of ``mxnet_tpu_torch.analysis`` in ``tree`` (absolute
    or relative)."""
    pkg = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
    out = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names = [mod] + [f"{mod}.{a.name}" for a in node.names]
        if any(n.startswith("mxnet_tpu_torch.analysis") for n in names):
            out.append(node.lineno)
    return out


@pytest.mark.parametrize("path", _lower_layer_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_lower_layers_do_not_import_analysis(path):
    """ops/ and parallel/ know nothing of analysis/: a schedule record
    fills their hook slots while it runs (``ops.kernels.HOOKS``,
    ``parallel.collectives.HOOK``)."""
    bad = _imports_analysis(_parse(path), path)
    assert not bad, f"{path} imports analysis/ at lines {bad}"


def test_analysis_import_check_catches_relative_imports():
    path = os.path.join(PKG, "ops", "kernels", "norm.py")
    tree = ast.parse("from ...analysis.schedule import x\n"
                     "from ... import analysis\nimport os\n"
                     "from .. import nn\n")
    assert _imports_analysis(tree, path) == [1, 2]
    assert len(_lower_layer_files()) >= 10


def _call_name(func):
    """Dotted name of a call target, e.g. ``F.layer_norm``."""
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
    return ".".join(reversed(parts))


def _library_call(name: str) -> bool:
    parts = name.split(".")
    if parts[-1] == "scaled_dot_product_attention":
        return True
    if parts[-1] == "layer_norm":
        return parts[0] in ("F", "torch") or "functional" in parts
    if parts[-1] == "compile":
        return parts[0] == "torch"
    if "_VF" in parts or "cudnn_rnn" in parts[-1]:
        return True
    if parts[-1] in _TORCH_RNN_MODULES:
        return parts[0] in ("nn", "torch")
    if parts[-1] in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        return parts[0] == "torch"
    if parts[-1].startswith(("_fused_adam", "_fused_sgd", "_foreach_")):
        return True
    return "optim" in parts[:-1] and parts[0] == "torch"


#: cuDNN-backed recurrent modules of ``torch.nn``
_TORCH_RNN_MODULES = ("LSTM", "GRU", "RNN", "LSTMCell", "GRUCell",
                      "RNNCell")


@pytest.mark.parametrize("path", _package_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_library_kernels_in_package(path):
    bad = [(n.lineno, _call_name(n.func))
           for n in ast.walk(_parse(path)) if isinstance(n, ast.Call)
           and _library_call(_call_name(n.func))]
    assert not bad, f"{path} calls {bad}"


def test_checks_catch_what_they_guard():
    tree = ast.parse("import jax\nfrom mxnet_tpu.ops import nn\n"
                     "import mxnet_tpu_torch\n"
                     "F.scaled_dot_product_attention(q, k, v)\n"
                     "torch.nn.functional.layer_norm(x, (4,))\n"
                     "torch.compile(f)\nK.layer_norm(x, g, b)\n"
                     "torch.nn.LSTM(4, 4)\nnn.GRU(4, 4)\n"
                     "torch._VF.lstm(x, hx, w)\ntorch.rnn_tanh(x, h, w)\n"
                     "torch._cudnn_rnn(x)\nrnn.LSTM(4, input_size=4)\n"
                     "LSTM(4, input_size=4)\n"
                     "nn.LSTMCell(4, 4)\ntorch.nn.GRUCell(4, 4)\n"
                     "nn.RNNCell(4, 4)\n"
                     "torch._fused_adam_(ws, gs, ms, vs, mx, st)\n"
                     "torch._fused_adamw_(ws)\ntorch._fused_sgd_(ws)\n"
                     "torch._foreach_add_(ws, gs)\n"
                     "torch.optim.Adam(ps)\nK.unit_update(w, g)\n")
    assert [n for _, n in _imports(tree) if _forbidden_module(n)] \
        == ["jax", "mxnet_tpu.ops"]
    calls = [_call_name(n.func) for n in ast.walk(tree)
             if isinstance(n, ast.Call) and _library_call(_call_name(n.func))]
    assert sorted(calls) == ["F.scaled_dot_product_attention",
                             "nn.GRU", "nn.LSTMCell", "nn.RNNCell",
                             "torch._VF.lstm", "torch._cudnn_rnn",
                             "torch._foreach_add_", "torch._fused_adam_",
                             "torch._fused_adamw_", "torch._fused_sgd_",
                             "torch.compile", "torch.nn.GRUCell",
                             "torch.nn.LSTM",
                             "torch.nn.functional.layer_norm",
                             "torch.optim.Adam", "torch.rnn_tanh"]
