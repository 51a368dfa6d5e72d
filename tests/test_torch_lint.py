"""The source lint of mxnet_tpu_torch (``analysis/lint.py``) against the
JAX package's, and the tier-1 sweep of the port.

The same source snippets give the same ``(rule, line, severity,
blessed)`` findings in both packages for every rule they share
(MXA001-MXA009); the port's torch forms (``.cpu()`` / ``.numpy()``,
``torch.rand*`` without ``generator=``, raw ``torch.distributed``
collectives, a bare lock outside ``analysis/threads.py``) fire their
rules. The ``lint``-marked sweep holds ``mxnet_tpu_torch/`` clean against
``tests/fixtures/torch_lint_allowlist.txt``. Every comparison is exact.
"""
import contextlib
import io
import os

import pytest

from mxnet_tpu_torch.analysis import lint as tlint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")
ALLOWLIST = os.path.join(ROOT, "tests", "fixtures", "torch_lint_allowlist.txt")

#: snippets both lints read alike (forward rules MXA001-006)
FORWARD = {
    "host_sync": '''
class Net:
    def forward(self, x):
        a = x.asnumpy()
        b = x.item()
        c = x.tolist()
        d = onp.asarray(x)
        e = x.asnumpy()  # mx-lint: allow=MXA001
        return x
''',
    "scalar_cast": '''
class Net:
    def forward(self, x, n):
        a = float(x)
        b = int(3)
        c = int(self.k)
        return x
''',
    "branch": '''
class Net:
    def forward(self, x, mask=None):
        if x.sum() > 0:
            x = x * 2
        if mask is None:
            x = x + 1
        while x.max() > 1:
            x = x / 2
        assert x.min() >= 0
        y = x if x.mean() > 0 else -x
        return y
''',
    "host_random": '''
import random
import numpy as np
class Net:
    def forward(self, x):
        a = np.random.rand(3)
        b = random.random()
        c = random.choice([1, 2])
        return x
''',
    "unroll": '''
class Net:
    def forward(self, x):
        for i in range(x.shape[0]):
            x = x + x[i]
        for j in range(4):
            x = x * 2
        for row in x:
            x = x + row
        return x
    def unroll(self, length, x, layout="NTC"):
        for t in range(length):
            x = x * 2
        if layout == "NTC":
            pass
        return x
''',
    "placement": '''
class Net:
    def forward(self, x):
        a = jax.device_put(x)
        b = place_on_mesh(x)
        c = lax.psum(x, "dp")
        d = jax.lax.all_gather(x, "dp")
        return x
''',
}

#: snippets both thread lints read alike (MXA007-009)
THREADS = {
    "blocking": '''
import time

class Worker:
    def step(self):
        with self._lock:
            time.sleep(0.1)
            self._queue.get()
            ", ".join(["a"])
    def step2(self):
        with self._mu:
            self.t.join()
            self.fut.result()
            self.pred.predict(1)
''',
    "shared": '''
import threading

class Counter:
    def __init__(self):
        self.count = 0
        self.t = threading.Thread(target=self._run)  # mx-lint: allow=MXA009
    def _run(self):
        self.count += 1
    def bump(self):
        self.count += 1
''',
    "bare": '''
import threading
lk = threading.Lock()
rl = threading.RLock()  # mx-lint: allow=MXA009
cv = threading.Condition()
''',
}


def _key(findings):
    return sorted((f.rule, int(f.where.rsplit(":", 1)[1]), f.severity,
                   f.blessed) for f in findings)


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_rules_find_what_jax_finds(name):
    from mxnet_tpu.analysis import lint as jlint
    src = FORWARD[name]
    ref = _key(jlint.lint_source(src, "snip.py"))
    got = _key(tlint.lint_source(src, "snip.py"))
    assert got == ref
    assert ref            # each snippet fires something


@pytest.mark.parametrize("name", sorted(THREADS))
def test_thread_rules_find_what_jax_finds(name):
    from mxnet_tpu.analysis import lint as jlint
    src = THREADS[name]
    ref = _key(jlint.lint_threads_source(src, "snip.py"))
    got = _key(tlint.lint_threads_source(src, "snip.py"))
    assert got == ref and ref


def test_lint_function_rebases_lines_as_jax():
    from mxnet_tpu.analysis import lint as jlint

    def loss(x, y):
        z = x.item()
        return z + y

    assert _key(tlint.lint_function(loss)) == \
        _key(jlint.lint_function(loss))
    (f,) = tlint.lint_function(loss)
    assert f.rule == "MXA001" and f.where.endswith(
        f":{loss.__code__.co_firstlineno + 1}")


def test_allowlist_format_is_the_jax_one(tmp_path):
    from mxnet_tpu.analysis import lint as jlint
    p = tmp_path / "allow.txt"
    p.write_text("# comment\nsnip.py::MXA001\nother.py\n\n")
    assert tlint.load_allowlist(str(p)) == jlint.load_allowlist(str(p))
    fs = tlint.lint_source(FORWARD["host_sync"], "pkg/snip.py")
    left = tlint.filter_allowed(fs, tlint.load_allowlist(str(p)))
    assert [f.rule for f in left] == []


TORCH_FORMS = '''
import torch
import torch.distributed as dist
import numpy as np
class Net:
    def forward(self, x):
        a = x.cpu()
        b = x.detach().numpy()
        c = torch.rand(3)
        d = torch.randn(2, 2, generator=self.gen)
        e = torch.randint(0, 4, (3,))
        f = torch.randperm(5)
        dist.all_reduce(x)
        torch.distributed.all_gather_into_tensor(a, x)
        return x
'''


def test_torch_forms_fire_their_rules():
    got = [(f.rule, int(f.where.rsplit(":", 1)[1]))
           for f in tlint.lint_source(TORCH_FORMS, "pkg/net.py")]
    assert sorted(got) == [("MXA001", 7), ("MXA001", 8),
                           ("MXA004", 9), ("MXA004", 11),
                           ("MXA004", 12), ("MXA006", 13),
                           ("MXA006", 14)]
    # the collectives' own module may call them
    home = tlint.lint_source(TORCH_FORMS, "pkg/parallel/collectives.py")
    assert "MXA006" not in {f.rule for f in home}


def test_bare_lock_outside_threads_module_only():
    src = "import threading\nlk = threading.Lock()\n"
    (f,) = tlint.lint_threads_source(src, "pkg/engine.py")
    assert f.rule == "MXA009" and "mx_lock" in f.message
    assert tlint.lint_threads_source(src, "pkg/analysis/threads.py") == []


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(FORWARD["unroll"].replace("range(4)", "range(len(x))")
                   + "\n")
    good = tmp_path / "good.py"
    good.write_text("class Net:\n    def forward(self, x):\n"
                    "        return x * 2\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert tlint.main([str(bad)]) == 1
        assert tlint.main([str(good)]) == 0
        assert tlint.main(["--threads", str(good)]) == 0
    assert "MXA005" in out.getvalue()


# ---------------------------------------------------------------------------
# the tier-1 sweep of the port
# ---------------------------------------------------------------------------

@pytest.mark.lint
def test_port_forwards_are_capture_safe():
    allow = tlint.load_allowlist(ALLOWLIST)
    left = tlint.filter_allowed(tlint.lint_path(PKG), allow)
    assert not left, "\n".join(str(f) for f in left)


@pytest.mark.lint
def test_port_thread_rules_are_clean():
    allow = tlint.load_allowlist(ALLOWLIST)
    left = tlint.filter_allowed(tlint.lint_threads_path(PKG), allow)
    assert not left, "\n".join(str(f) for f in left)


@pytest.mark.lint
def test_allowlist_entries_all_still_hit():
    """A stale entry (its finding gone) must be removed, so the list
    keeps saying only what is true."""
    findings = tlint.lint_path(PKG) + tlint.lint_threads_path(PKG)
    hit = {(f.where.rsplit(":", 1)[0].replace(os.sep, "/"), f.rule)
           for f in findings if not f.blessed}
    for suffix, rule in tlint.load_allowlist(ALLOWLIST):
        assert any(p.endswith(suffix) and r == rule for p, r in hit), \
            f"stale allowlist entry {suffix}::{rule}"
