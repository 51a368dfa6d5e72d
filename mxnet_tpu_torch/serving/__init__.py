"""Serving (counterpart of ``mxnet_tpu/serving``): the bucketed
:class:`CompiledPredictor`, the :class:`DynamicBatcher` with deadlines,
admission shedding and drain, the :class:`ServingSupervisor` and
:class:`CircuitBreaker` of :mod:`.resilience`, the multi-replica
:class:`FleetController` / :class:`FleetRouter` of :mod:`.fleet`, the
continuous-batching :class:`DecodeEngine` over the paged
:class:`PagedKVCache`, and the load generator."""
from . import decode, fleet, kvcache, loadgen, resilience
from .batcher import (DynamicBatcher, ServingFuture, batch_timeout_s,
                      max_batch_rows, queue_depth)
from .decode import (DecodeEngine, DecodeStream, ModelDrafter, NgramDrafter,
                     TinyDecoder, kv_page_size, prefill_chunk, prefix_share,
                     run_decode, slot_ladder, spec_k)
from .fleet import (FleetController, FleetEvent, FleetRouter,
                    fleet_max_replicas, fleet_min_replicas, fleet_replicas,
                    fleet_restart_retries, fleet_scale_down_wait_s,
                    fleet_scale_up_wait_s)
from .kvcache import KV_PAGE_SIZE, PagedKVCache, pages_needed, prefix_hash
from .predictor import DEFAULT_BUCKETS, CompiledPredictor, predictor_for
from .resilience import (CircuitBreaker, DeadlineExceeded, Overloaded,
                         ServingShutdown, ServingSupervisor,
                         default_deadline_ms, queue_timeout_s, shed_mode,
                         transient_retries)

__all__ = ["CompiledPredictor", "DynamicBatcher", "ServingFuture",
           "predictor_for", "DEFAULT_BUCKETS", "loadgen", "resilience",
           "max_batch_rows", "batch_timeout_s", "queue_depth",
           "CircuitBreaker", "ServingSupervisor", "DeadlineExceeded",
           "Overloaded", "ServingShutdown", "default_deadline_ms",
           "queue_timeout_s", "shed_mode", "transient_retries",
           "decode", "kvcache", "DecodeEngine", "DecodeStream",
           "TinyDecoder", "PagedKVCache", "KV_PAGE_SIZE",
           "pages_needed", "run_decode", "slot_ladder", "kv_page_size",
           "prefill_chunk", "prefix_hash", "NgramDrafter",
           "ModelDrafter", "spec_k", "prefix_share",
           "fleet", "FleetController", "FleetRouter",
           "FleetEvent", "fleet_replicas", "fleet_min_replicas",
           "fleet_max_replicas", "fleet_scale_up_wait_s",
           "fleet_scale_down_wait_s", "fleet_restart_retries"]
