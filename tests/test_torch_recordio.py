"""The port's ``recordio`` against the JAX package's.

The same records go through both packages' writers: the files must be
byte-equal, whichever writer the JAX package takes (its native
``src/native/recordio.cc`` where that library is built, else its Python
one; both are tried), and each package reads the other's files, the
indexed ``.idx`` files included. The records cover an empty payload,
lengths 1-7 (the padding to 4 bytes), payloads that hold the magic word
at aligned offsets and multi-label headers. Exact throughout: bytes are
compared as bytes.
"""
import struct

import numpy as onp
import pytest

from mxnet_tpu import recordio as jrio

from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch.base import MXNetError

MAGIC = struct.pack("<I", 0xced7230a)


def _payloads():
    r = onp.random.RandomState(3)
    out = [b""]
    out += [bytes(r.randint(0, 256, n, dtype=onp.uint8)) for n in range(1, 8)]
    out += [MAGIC, MAGIC * 3, b"ab" + MAGIC + b"cd" + MAGIC,
            MAGIC + struct.pack("<I", 12) + b"x" * 12]
    out += [bytes(r.randint(0, 256, n, dtype=onp.uint8))
            for n in (4093, 4096, 65537)]
    return out


def _headers():
    return [trio.IRHeader(0, 3.0, 7, 0), trio.IRHeader(0, -1.5, 1, 2),
            trio.IRHeader(0, [1.0, 2.5, 3.0], 9, 4),
            trio.IRHeader(0, onp.arange(7, dtype="float32"), 11, 0)]


def _records():
    recs = list(_payloads())
    for i, h in enumerate(_headers()):
        recs.append(trio.pack(h, _payloads()[i + 3]))
    return recs


@pytest.fixture(params=["native", "python"])
def jax_writer(request, monkeypatch):
    """The JAX package with its native library (when built) or its
    Python reader and writer."""
    if request.param == "python":
        monkeypatch.setattr(jrio._native, "available", lambda: False)
    elif not jrio._native.available():
        pytest.skip("the JAX package's native library is not built here")
    return request.param


def _write(mod, path, recs):
    w = mod.MXRecordIO(str(path), "w")
    offsets = [w.write(r) for r in recs]
    w.close()
    return offsets


def _read_all(mod, path):
    r = mod.MXRecordIO(str(path), "r")
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


def test_files_are_byte_equal_and_cross_read(tmp_path, jax_writer):
    recs = _records()
    t_off = _write(trio, tmp_path / "t.rec", recs)
    j_off = _write(jrio, tmp_path / "j.rec", recs)
    assert (tmp_path / "t.rec").read_bytes() == \
        (tmp_path / "j.rec").read_bytes()
    assert t_off == j_off
    assert _read_all(trio, tmp_path / "j.rec") == recs
    assert _read_all(jrio, tmp_path / "t.rec") == recs


def test_framing_of_each_length(tmp_path):
    """Header, payload, zero padding to 4 bytes, for lengths 0-7."""
    for n in range(8):
        path = tmp_path / f"{n}.rec"
        _write(trio, path, [b"\x01" * n])
        pad = (4 - n % 4) % 4
        assert path.read_bytes() == (MAGIC + struct.pack("<I", n)
                                     + b"\x01" * n + b"\x00" * pad)


def test_indexed_files_equal_both_ways(tmp_path, jax_writer):
    recs = _records()
    keys = [5 * i + 2 for i in range(len(recs))]
    for mod, name in ((trio, "t"), (jrio, "j")):
        w = mod.MXIndexedRecordIO(str(tmp_path / f"{name}.idx"),
                                  str(tmp_path / f"{name}.rec"), "w")
        for k, rec in zip(keys, recs):
            w.write_idx(k, rec)
        assert w.tell() == sum(8 + len(r) + (-len(r)) % 4 for r in recs)
        w.close()
    for ext in ("rec", "idx"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    order = onp.random.RandomState(4).permutation(len(keys))
    for mod, other in ((trio, "j"), (jrio, "t")):
        r = mod.MXIndexedRecordIO(str(tmp_path / f"{other}.idx"),
                                  str(tmp_path / f"{other}.rec"), "r")
        assert r.keys == keys
        for i in order:
            assert r.read_idx(keys[i]) == recs[i]
        r.close()


@pytest.mark.parametrize("i", range(4))
def test_pack_and_unpack_match_jax(i):
    h = _headers()[i]
    payload = _payloads()[i + 2]
    t, j = trio.pack(h, payload), jrio.pack(jrio.IRHeader(*h), payload)
    assert t == j
    th, tp = trio.unpack(t)
    jh, jp = jrio.unpack(j)
    assert tp == jp == payload
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    onp.testing.assert_array_equal(onp.asarray(th.label),
                                   onp.asarray(jh.label))
    if isinstance(h.label, (list, onp.ndarray)):
        assert th.flag == len(h.label) and th.label.dtype == onp.float32


@pytest.mark.parametrize("fmt,quality", [(".jpg", 95), (".jpg", 50),
                                         (".png", 3)])
def test_pack_img_matches_jax(fmt, quality):
    pytest.importorskip("PIL")
    img = onp.random.RandomState(5).randint(0, 256, (12, 10, 3)) \
        .astype("uint8")
    h = trio.IRHeader(0, 4.0, 1, 0)
    t = trio.pack_img(h, img, quality=quality, img_fmt=fmt)
    assert t == jrio.pack_img(jrio.IRHeader(*h), img, quality=quality,
                              img_fmt=fmt)
    th, timg = trio.unpack_img(t)
    jh, jimg = jrio.unpack_img(t)
    assert th.label == jh.label == 4.0
    onp.testing.assert_array_equal(timg, jimg)
    if fmt == ".png":
        onp.testing.assert_array_equal(timg, img)
    with pytest.raises(MXNetError):
        trio.pack_img(h, img, img_fmt=".gif")


def test_pack_img_without_pil_raises(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(MXNetError, match="PIL"):
        trio.pack_img(trio.IRHeader(0, 0.0, 0, 0), onp.zeros((2, 2, 3)))
    with pytest.raises(MXNetError, match="PIL"):
        trio.unpack_img(trio.pack(trio.IRHeader(0, 0.0, 0, 0), b"xx"))


def test_errors(tmp_path):
    path = tmp_path / "a.rec"
    _write(trio, path, [b"abcdef"])
    with pytest.raises(MXNetError):
        trio.MXRecordIO(str(path), "x")
    w = trio.MXRecordIO(str(tmp_path / "b.rec"), "w")
    with pytest.raises(MXNetError):
        w.read()
    w.close()
    r = trio.MXRecordIO(str(path), "r")
    with pytest.raises(MXNetError):
        r.write(b"x")
    r.close()
    data = path.read_bytes()
    for bad, what in ((b"\x00" + data[1:], "bad magic"),
                      (data[:6], "truncated header"),
                      (data[:10], "truncated payload")):
        (tmp_path / "bad.rec").write_bytes(bad)
        with pytest.raises(MXNetError, match=what):
            _read_all(trio, tmp_path / "bad.rec")
    with trio.MXRecordIO(str(path), "r") as r:
        assert r.read() == b"abcdef" and r.read() is None
        r.reset()
        assert r.read() == b"abcdef"
    assert not r.is_open
