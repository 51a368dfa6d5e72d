"""Vision datasets (counterpart of ``mxnet_tpu/gluon/data/vision/
datasets.py``).

``MNIST`` / ``FashionMNIST`` read the idx-ubyte files and ``CIFAR10`` /
``CIFAR100`` the binary batches under ``root`` when they are there;
otherwise each gives the JAX package's synthetic stand-in, the same
arrays for the same split (a class template plus noise, so a model can
fit it). Nothing is downloaded. A sample is ``(HWC uint8 tensor,
int label)``, through ``transform(img, label)`` when one is given.
``ImageFolderDataset`` reads a folder of class folders through
``image.imread``; ``ImageRecordDataset`` decodes the records of a
RecordIO file through ``image.imdecode``.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....base import MXNetError, data_dir
from ....host import to_tensor
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]


def _synthetic_mnist(num: int, seed: int, num_classes: int = 10,
                     template_seed: int = None):
    """Class templates from ``template_seed`` (shared by both splits)
    plus noise and labels from ``seed``."""
    t_rng = np.random.RandomState(
        template_seed if template_seed is not None else seed)
    templates = t_rng.rand(num_classes, 28, 28).astype("float32")
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=num).astype("int32")
    noise = rng.rand(num, 28, 28).astype("float32") * 0.5
    images = templates[labels] + noise
    images = (images / images.max() * 255).astype("uint8")
    return images[..., None], labels


class _ArrayImages(Dataset):
    """Images and labels held as arrays."""

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        img = to_tensor(np.array(self._data[idx]))
        lbl = int(self._label[idx])
        if self._transform is not None:
            return self._transform(img, lbl)
        return img, lbl


class MNIST(_ArrayImages):
    """MNIST: 28 x 28 x 1 images, 10 classes (60,000 / 10,000 from the
    files; 8,000 / 2,000 synthetic)."""

    _base_seed = 42
    _subdir = "mnist"

    def __init__(self, root=None, train=True, transform=None):
        if root is None:
            root = os.path.join(data_dir(), "datasets", self._subdir)
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._load()

    def _file_names(self):
        if self._train:
            return ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
        return ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def _load(self):
        img_name, lbl_name = self._file_names()
        img_path = os.path.join(self._root, img_name)
        lbl_path = os.path.join(self._root, lbl_name)
        if os.path.exists(img_path) or os.path.exists(img_path + ".gz"):
            self._data, self._label = self._read_idx(img_path, lbl_path)
        else:
            n = 8000 if self._train else 2000
            self._data, self._label = _synthetic_mnist(
                n, self._base_seed + (0 if self._train else 1),
                template_seed=self._base_seed)

    @staticmethod
    def _read_idx(img_path, lbl_path):
        def opener(p):
            return gzip.open(p + ".gz", "rb") if os.path.exists(p + ".gz") \
                else open(p, "rb")
        with opener(lbl_path) as f:
            struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8).astype("int32")
        with opener(img_path) as f:
            _, num, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8) \
                .reshape(num, rows, cols, 1)
        return images, labels


class FashionMNIST(MNIST):
    _base_seed = 77
    _subdir = "fashion-mnist"


class CIFAR10(_ArrayImages):
    """CIFAR-10: 32 x 32 x 3 images (50,000 / 10,000 from the files;
    4,000 / 1,000 synthetic)."""

    _num_classes = 10
    _subdir = "cifar10"

    def __init__(self, root=None, train=True, transform=None):
        if root is None:
            root = os.path.join(data_dir(), "datasets", self._subdir)
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._load()

    def _load(self):
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] if self._train \
            else ["test_batch.bin"]
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            datas, labels = [], []
            rec = 1 + 3072 if self._num_classes == 10 else 2 + 3072
            for p in paths:
                raw = np.fromfile(p, dtype=np.uint8).reshape(-1, rec)
                labels.append(raw[:, rec - 3073].astype("int32"))
                datas.append(raw[:, rec - 3072:].reshape(-1, 3, 32, 32)
                             .transpose(0, 2, 3, 1))
            self._data = np.concatenate(datas)
            self._label = np.concatenate(labels)
        else:
            # templates from a split-independent seed: both splits share
            # the classes' structure
            t_rng = np.random.RandomState(123 + self._num_classes)
            templates = t_rng.rand(self._num_classes, 32, 32, 3) \
                .astype("float32")
            rng = np.random.RandomState(123 if self._train else 321)
            n = 4000 if self._train else 1000
            self._label = rng.randint(0, self._num_classes, n).astype("int32")
            imgs = templates[self._label] + \
                rng.rand(n, 32, 32, 3).astype("float32") * 0.5
            self._data = (imgs / imgs.max() * 255).astype("uint8")


class CIFAR100(CIFAR10):
    """CIFAR-100 (the fine label of the binary files)."""

    _num_classes = 100
    _subdir = "cifar100"

    def __init__(self, root=None, train=True, transform=None,
                 fine_label=True):
        super().__init__(root, train, transform)


class ImageFolderDataset(Dataset):
    """``root/<class>/<image>``: one label a class folder, in sorted
    order (``synsets``); ``.jpg``, ``.jpeg``, ``.png``, ``.bmp`` and
    ``.npy`` files, read with ``image.imread(path, flag)``."""

    def __init__(self, root: str, flag: int = 1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        if not os.path.isdir(self._root):
            raise MXNetError(f"{self._root} is not a directory")
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp",
                                           ".npy")):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        img = imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageRecordDataset(Dataset):
    """The images of a RecordIO file (``recordio.pack_img`` records): a
    sample is ``(HWC uint8 tensor, label)``, the label an int, or a
    float32 tensor for a multi-label header."""

    def __init__(self, filename: str, flag: int = 1, transform=None):
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from .... import recordio
        from ....image import imdecode
        header, img_bytes = recordio.unpack(self._record[idx])
        img = imdecode(img_bytes, self._flag)
        label = int(header.label) if np.isscalar(header.label) \
            else to_tensor(np.array(header.label))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
