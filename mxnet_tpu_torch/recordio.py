"""RecordIO files (counterpart of ``mxnet_tpu/recordio.py``, MXNet's
``recordio.py``).

The dmlc framing in pure Python: each record is the magic word
``0xced7230a``, a little-endian ``uint32`` of ``cflag << 29 | length``
(cflag 0, a whole record), the payload, and zero bytes up to a 4-byte
boundary. The files are byte-equal to those either writer of the JAX
package makes (its native ``src/native/recordio.cc`` or its Python one),
and each package reads the other's. ``MXIndexedRecordIO`` keeps a text
index of ``key\\tposition`` lines beside the file.

``IRHeader`` / ``pack`` / ``unpack`` frame an image record's label
(struct ``IfQQ``: flag, label, id, id2; ``flag > 0`` means ``flag``
float32 labels follow the header). ``pack_img`` / ``unpack_img`` encode
and decode with PIL and raise :class:`MXNetError` without it.
"""
from __future__ import annotations

import collections
import io
import os
import struct
import threading
from typing import Optional

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LREC_MASK = (1 << 29) - 1

IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class _Writer:
    def __init__(self, path):
        self._f = open(path, "wb")
        self._pos = 0

    def write(self, data: bytes) -> int:
        if len(data) >= (1 << 29):
            raise MXNetError("recordio: record too large (>512MB)")
        pos = self._pos
        pad = (4 - (len(data) & 3)) & 3
        self._f.write(struct.pack("<II", _MAGIC, len(data)))
        self._f.write(data)
        if pad:
            self._f.write(b"\x00" * pad)
        self._pos += 8 + len(data) + pad
        return pos

    def tell(self) -> int:
        return self._pos

    def close(self):
        self._f.close()


class _Reader:
    def __init__(self, path):
        self._f = open(path, "rb")

    def read(self) -> Optional[bytes]:
        hdr = self._f.read(8)
        if not hdr:
            return None
        if len(hdr) < 4 or struct.unpack("<I", hdr[:4])[0] != _MAGIC:
            raise MXNetError("recordio: bad magic (corrupt or misaligned)")
        if len(hdr) != 8:
            raise MXNetError("recordio: truncated header")
        length = struct.unpack("<I", hdr[4:])[0] & _LREC_MASK
        data = self._f.read(length)
        if len(data) != length:
            raise MXNetError("recordio: truncated payload")
        pad = (4 - (length & 3)) & 3
        if pad:
            self._f.read(pad)
        return data

    def seek(self, pos):
        self._f.seek(pos)

    def tell(self):
        return self._f.tell()

    def close(self):
        self._f.close()


class MXRecordIO:
    """A RecordIO file read or written in order. ``uri``: its path;
    ``flag``: ``"r"`` or ``"w"``."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self._rec = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self._rec = _Writer(self.uri)
        elif self.flag == "r":
            self._rec = _Reader(self.uri)
        else:
            raise MXNetError(f"invalid flag {self.flag!r}, expected 'r'/'w'")
        self.is_open = True

    def write(self, buf: bytes) -> int:
        """Append one record; returns its offset in the file."""
        if self.flag != "w":
            raise MXNetError("recordio: not opened for writing")
        return self._rec.write(bytes(buf))

    def read(self) -> Optional[bytes]:
        """The next record, or None at the end of the file."""
        if self.flag != "r":
            raise MXNetError("recordio: not opened for reading")
        return self._rec.read()

    def reset(self):
        self.close()
        self.open()

    def close(self):
        if self._rec is not None:
            self._rec.close()
            self._rec = None
        self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MXIndexedRecordIO(MXRecordIO):
    """A RecordIO file with random access through its index file
    ``idx_path`` (lines of ``key\\tposition``; written on close).
    :meth:`read_idx` may be called from several threads at once (a
    loader's workers): its seek and read hold a lock."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.key_type = key_type
        self.idx = {}
        self.keys = []
        self._seek_mu = threading.Lock()
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        k = key_type(parts[0])
                        self.idx[k] = int(parts[1])
                        self.keys.append(k)

    def close(self):
        if self.flag == "w" and self.idx:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        if self.flag != "r":
            raise MXNetError("recordio: seek requires read mode")
        self._rec.seek(self.idx[idx])

    def tell(self) -> int:
        return self._rec.tell()

    def read_idx(self, idx) -> bytes:
        with self._seek_mu:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self.write(buf)
        self.idx[self.key_type(idx)] = pos
        self.keys.append(self.key_type(idx))


def pack(header: IRHeader, s: bytes) -> bytes:
    """A label header and a payload as one record: a list, tuple or
    array label is written as ``flag`` float32 values after the header
    (and the header's label 0)."""
    label = header.label
    if isinstance(label, (np.ndarray, list, tuple)):
        label = np.asarray(label, np.float32)
        header = header._replace(flag=label.size, label=0.0)
        return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, float(label), header.id,
                       header.id2) + s


def unpack(s: bytes):
    """The inverse of :func:`pack`: ``(IRHeader, payload)``; a
    multi-label header's label is a float32 array."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("image encoding and decoding need PIL, which is "
                         "not installed; store raw arrays instead") from e
    return Image


def pack_img(header: IRHeader, img, quality=95, img_fmt=".jpg") -> bytes:
    """Encode an HWC (or HW) image with PIL and pack it: JPEG at
    ``quality`` 1-100, or PNG with ``quality`` as its compression level
    0-9. Values outside uint8 are clipped."""
    Image = _pil()
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    im = Image.fromarray(arr)
    buf = io.BytesIO()
    fmt = img_fmt.lower()
    if fmt in (".jpg", ".jpeg"):
        im.save(buf, format="JPEG", quality=int(quality))
    elif fmt == ".png":
        im.save(buf, format="PNG",
                compress_level=min(max(int(quality), 0), 9))
    else:
        raise MXNetError(f"unsupported image format {img_fmt!r}; "
                         "use .jpg or .png")
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor=1):
    """:func:`unpack` and a PIL decode of the payload: ``(IRHeader, HWC
    uint8 array)`` (RGB when ``iscolor``)."""
    header, img_bytes = unpack(s)
    im = _pil().open(io.BytesIO(img_bytes))
    if iscolor:
        im = im.convert("RGB")
    return header, np.asarray(im)
