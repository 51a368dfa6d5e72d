"""Serving (counterpart of ``mxnet_tpu/serving``): the bucketed
:class:`CompiledPredictor`, the :class:`DynamicBatcher`, the typed
failures of :mod:`.resilience`, the continuous-batching
:class:`DecodeEngine` over the paged :class:`PagedKVCache`, and the load
generator."""
from . import decode, kvcache, loadgen, resilience
from .batcher import DynamicBatcher, ServingFuture, queue_depth
from .decode import (DecodeEngine, DecodeStream, ModelDrafter, NgramDrafter,
                     TinyDecoder, kv_page_size, prefill_chunk, prefix_share,
                     run_decode, slot_ladder, spec_k)
from .kvcache import KV_PAGE_SIZE, PagedKVCache, pages_needed, prefix_hash
from .predictor import DEFAULT_BUCKETS, CompiledPredictor
from .resilience import (DeadlineExceeded, Overloaded, ServingShutdown,
                         default_deadline_ms, shed_mode)

__all__ = ["CompiledPredictor", "DEFAULT_BUCKETS", "DynamicBatcher",
           "ServingFuture", "Overloaded", "ServingShutdown",
           "DeadlineExceeded", "default_deadline_ms", "shed_mode",
           "queue_depth", "loadgen", "resilience", "decode", "kvcache",
           "DecodeEngine", "DecodeStream", "TinyDecoder", "PagedKVCache",
           "KV_PAGE_SIZE", "pages_needed", "prefix_hash", "run_decode",
           "slot_ladder", "kv_page_size", "prefill_chunk", "spec_k",
           "prefix_share", "NgramDrafter", "ModelDrafter"]
