"""The data-iterator API (counterpart of ``mxnet_tpu/io``): ``DataIter``s
yield ``DataBatch``es with ``provide_data`` / ``provide_label``
descriptors, MXNet's input pipeline from before Gluon."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, ImageRecordIter,
                 MXDataIter, NDArrayIter, PrefetchingIter, ResizeIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "ResizeIter", "PrefetchingIter", "ImageRecordIter", "MXDataIter"]
