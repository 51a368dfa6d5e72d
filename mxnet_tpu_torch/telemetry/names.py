"""Metric-name catalog — the single source of truth for runtime telemetry
(the port's copy of ``mxnet_tpu/telemetry/names.py``, kept whole: the
same series, kinds, label keys and help text, so both packages export one
Prometheus schema; ``tests/test_torch_telemetry.py`` holds them equal).

The help text is the JAX package's word for word. Where it names a JAX
mechanism the port reads its counterpart: ``mx_kernel_dispatch_total``'s
``path`` label is ``cuda`` for a launched hand-written kernel and
``plain`` for a CPU tensor's plain PyTorch version (the JAX package's
``pallas | interpret | xla``); ``mx_model_flops_per_step`` is the eager
step's ``FlopCounterMode`` count plus each kernel wrapper's own count
(the port has no ``cost_analysis()``); ``mx_mem_untracked_bytes`` is the
allocator's bytes in use that no census pool claims.

Every metric the framework registers lives HERE as a module constant,
and the registry enforces it at registration time: a name must match the
convention regex, and any ``mx_``-prefixed name must be declared in
:data:`CATALOG` with the kind it is registered as.  Framework code never
passes string literals to ``registry.counter/gauge/histogram`` — it
imports the constant (the tier-1 lint sweep in
tests/test_torch_telemetry.py greps the port for violations), so exporter
cardinality cannot silently drift: a new series requires a catalog entry,
which requires touching this file and docs/OBSERVABILITY.md.

Naming convention (Prometheus-compatible):

- ``<prefix>_<what>[_<unit>]``, lowercase snake case, >= 2 tokens
  (:data:`NAME_RE`); the ``mx_`` prefix is RESERVED for catalog
  entries — user code registers its own metrics under its own prefix;
- counters end in ``_total``;
- histograms end in a unit suffix (``_seconds`` for latencies,
  ``_ratio`` for unitless ratios such as the numerics update/weight
  ratio);
- gauges end in neither ``_total`` nor ``_bucket`` (a unit suffix such
  as ``_seconds`` is fine);
- label keys are single, fixed per metric, with bounded value
  cardinality (:data:`MAX_LABEL_VALUES`; overflow collapses into
  :data:`OVERFLOW_LABEL`).
"""
from __future__ import annotations

import re

__all__ = ["NAME_RE", "MAX_LABEL_VALUES", "OVERFLOW_LABEL", "CATALOG",
           "is_valid", "kind_ok", "check"]

NAME_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)+$")

#: max distinct label values per labeled metric before new values
#: collapse into OVERFLOW_LABEL (bounded exporter cardinality)
MAX_LABEL_VALUES = 24
OVERFLOW_LABEL = "other"

# ---------------------------------------------------------------------------
# engine / dispatch window
# ---------------------------------------------------------------------------
TRAIN_STEPS = "mx_train_steps_total"
WINDOW_PUSHES = "mx_engine_window_pushes_total"
WINDOW_RETIRES = "mx_engine_window_retires_total"
WINDOW_ERRORS = "mx_engine_window_errors_total"
WINDOW_OCCUPANCY = "mx_engine_window_occupancy"
WINDOW_CAPACITY = "mx_engine_window_capacity"

# ---------------------------------------------------------------------------
# transfer guard (analysis/guard.py sync census)
# ---------------------------------------------------------------------------
HOST_SYNCS = "mx_guard_host_syncs_total"

# ---------------------------------------------------------------------------
# device input prefetch (gluon/data/prefetcher.py)
# ---------------------------------------------------------------------------
PREFETCH_BATCHES = "mx_prefetch_batches_total"
PREFETCH_STARVATION = "mx_prefetch_starvation_total"
PREFETCH_INPUT_WAIT = "mx_prefetch_input_wait_seconds_total"

# ---------------------------------------------------------------------------
# compilation (runtime.py persistent cache + fused_step retraces)
# ---------------------------------------------------------------------------
COMPILE_CACHE_HITS = "mx_compile_cache_hits_total"
COMPILE_CACHE_MISSES = "mx_compile_cache_misses_total"
COMPILE_CACHE_ENABLED = "mx_compile_cache_enabled"
COMPILE_RETRACES = "mx_compile_retraces_total"

# ---------------------------------------------------------------------------
# checkpoint (checkpoint/manager.py)
# ---------------------------------------------------------------------------
CHECKPOINT_SAVES = "mx_checkpoint_saves_total"
CHECKPOINT_ERRORS = "mx_checkpoint_errors_total"
CHECKPOINT_RESTORES = "mx_checkpoint_restores_total"
CHECKPOINT_CAPTURE_SECONDS = "mx_checkpoint_capture_seconds"
CHECKPOINT_SAVE_SECONDS = "mx_checkpoint_save_seconds"
CHECKPOINT_RECOVERY_SECONDS = "mx_checkpoint_recovery_seconds"

# ---------------------------------------------------------------------------
# elastic training supervisor (elastic/supervisor.py)
# ---------------------------------------------------------------------------
ELASTIC_RECOVERIES = "mx_elastic_recoveries_total"
ELASTIC_DOWNTIME_SECONDS = "mx_elastic_recovery_downtime_seconds"
ELASTIC_WORLD_SIZE = "mx_elastic_world_size"
ELASTIC_PREEMPTIONS = "mx_elastic_preemptions_total"

# ---------------------------------------------------------------------------
# step timeline (telemetry/timeline.py)
# ---------------------------------------------------------------------------
STEP_PHASE_SECONDS = "mx_step_phase_seconds"
STEP_TIME_SECONDS = "mx_step_time_seconds"

# ---------------------------------------------------------------------------
# MFU gauge + anomaly watchdog (telemetry/watchdog.py)
# ---------------------------------------------------------------------------
MODEL_FLOPS_PER_STEP = "mx_model_flops_per_step"
MODEL_FLOPS_PER_SEC = "mx_model_flops_per_sec"
MFU = "mx_model_mfu_ratio"
STEP_TIME_EWMA = "mx_watchdog_step_time_ewma_seconds"
ANOMALIES = "mx_anomalies_total"

# ---------------------------------------------------------------------------
# device-memory observability (telemetry/memory.py)
# ---------------------------------------------------------------------------
HBM_COMPILED_BYTES = "mx_hbm_compiled_bytes"
HBM_PEAK_BYTES = "mx_hbm_peak_estimate_bytes"
MEM_POOL_BYTES = "mx_mem_pool_bytes"
MEM_POOL_BUFFERS = "mx_mem_pool_buffers"
MEM_UNTRACKED_BYTES = "mx_mem_untracked_bytes"
MEM_DEVICE_IN_USE = "mx_mem_device_bytes_in_use"
MEM_DEVICE_PEAK = "mx_mem_device_peak_bytes"
MEM_DEVICE_LIMIT = "mx_mem_device_limit_bytes"
MEM_BUDGET_BYTES = "mx_mem_budget_bytes"
OOM_DUMPS = "mx_mem_oom_dumps_total"

# ---------------------------------------------------------------------------
# training-numerics observability (telemetry/numerics.py)
# ---------------------------------------------------------------------------
NUMERICS_GRAD_NORM = "mx_numerics_grad_norm"
NUMERICS_PARAM_NORM = "mx_numerics_param_norm"
NUMERICS_GRAD_NORM_EWMA = "mx_numerics_grad_norm_ewma"
NUMERICS_UPDATE_RATIO = "mx_numerics_update_ratio"
NUMERICS_LAYER_GRAD_NORM = "mx_numerics_layer_grad_norm"
NUMERICS_MASTER_DRIFT = "mx_numerics_master_drift"
NUMERICS_NONFINITE = "mx_numerics_nonfinite_total"
NUMERICS_DUMPS = "mx_numerics_dumps_total"

# ---------------------------------------------------------------------------
# fusion census (analysis/fusion.py)
# ---------------------------------------------------------------------------
FUSION_REGIONS = "mx_fusion_regions"
FUSION_STRANDED = "mx_fusion_stranded_ops"
FUSION_BOUNDARY_BYTES = "mx_fusion_boundary_bytes"
FUSION_COMPUTE_BOUND = "mx_fusion_compute_bound_ratio"

# ---------------------------------------------------------------------------
# SPMD sharding analysis (analysis/sharding.py)
# ---------------------------------------------------------------------------
SHARDING_RESHARDS = "mx_sharding_implicit_reshards"
SHARDING_RESHARD_BYTES = "mx_sharding_reshard_bytes"
SHARDING_COMM_COST = "mx_sharding_comm_cost_seconds"
SHARDING_COLLECTIVE_BYTES = "mx_sharding_collective_bytes"
SHARDING_EXPOSED_COMM = "mx_sharding_exposed_comm_seconds"
OVERLAP_FRACTION = "mx_overlap_fraction"

# ---------------------------------------------------------------------------
# Pallas kernel layer (ops/kernels dispatch gate)
# ---------------------------------------------------------------------------
KERNEL_DISPATCH = "mx_kernel_dispatch_total"

# ---------------------------------------------------------------------------
# self-tuning performance autopilot (tuning/)
# ---------------------------------------------------------------------------
AUTOTUNE_TRIALS = "mx_autotune_trials_total"
AUTOTUNE_CACHE_HITS = "mx_autotune_cache_hits_total"
AUTOTUNE_CACHE_MISSES = "mx_autotune_cache_misses_total"
AUTOTUNE_ACTIVE = "mx_autotune_active_config"

# ---------------------------------------------------------------------------
# inference serving engine (serving/batcher.py)
# ---------------------------------------------------------------------------
SERVING_REQUESTS = "mx_serving_requests_total"
SERVING_BATCHES = "mx_serving_batches_total"
SERVING_QUEUE_DEPTH = "mx_serving_queue_depth"
SERVING_INFLIGHT = "mx_serving_inflight_batches"
SERVING_OCCUPANCY = "mx_serving_batch_occupancy_ratio"
SERVING_LATENCY = "mx_serving_request_seconds"

# ---------------------------------------------------------------------------
# resilient serving (serving/resilience.py + batcher.py admission control)
# ---------------------------------------------------------------------------
SERVING_REJECTED = "mx_serving_rejected_total"
SERVING_DEADLINE_MISSED = "mx_serving_deadline_missed_total"
SERVING_RETRIES = "mx_serving_retries_total"
SERVING_RECOVERIES = "mx_serving_recoveries_total"
SERVING_BREAKER_STATE = "mx_serving_breaker_state"
SERVING_DRAIN_SECONDS = "mx_serving_drain_seconds"

# ---------------------------------------------------------------------------
# continuous-batching decode engine (serving/decode.py + kvcache.py)
# ---------------------------------------------------------------------------
DECODE_TOKENS = "mx_decode_tokens_total"
DECODE_ACTIVE_SLOTS = "mx_decode_active_slots"
DECODE_KV_PAGES = "mx_decode_kv_pages"
DECODE_TTFT_SECONDS = "mx_decode_ttft_seconds"
DECODE_TPOT_SECONDS = "mx_decode_tpot_seconds"
DECODE_SPEC_DRAFTED = "mx_decode_spec_drafted_total"
DECODE_SPEC_ACCEPTED = "mx_decode_spec_accepted_total"
DECODE_PREFIX_HITS = "mx_decode_prefix_hits_total"
DECODE_COW_COPIES = "mx_decode_cow_copies_total"

# ---------------------------------------------------------------------------
# serving fleet controller (serving/fleet.py)
# ---------------------------------------------------------------------------
FLEET_REPLICAS = "mx_fleet_replicas"
FLEET_ROUTED = "mx_fleet_routed_requests_total"
FLEET_RESTARTS = "mx_fleet_replica_restarts_total"
FLEET_SWAPS = "mx_fleet_weight_swaps_total"
FLEET_SCALE_EVENTS = "mx_fleet_scale_events_total"
FLEET_QUEUE_WAIT = "mx_fleet_queue_wait_seconds"

# ---------------------------------------------------------------------------
# telemetry self-observation (telemetry/exporters.py)
# ---------------------------------------------------------------------------
HEARTBEATS = "mx_telemetry_heartbeats_total"

# ---------------------------------------------------------------------------
# thread/lock audit (analysis/threads.py)
# ---------------------------------------------------------------------------
THREADS_HELD = "mx_threads_held_locks"
THREADS_LONGEST_WAIT = "mx_threads_longest_wait_seconds"
THREADS_LOCK_WAIT = "mx_threads_lock_wait_seconds"
THREADS_DUMPS = "mx_threads_dumps_total"


#: name -> {kind, help, label}: the complete set of series the framework
#: may export. Registration of an unknown ``mx_*`` name raises.
CATALOG = {
    TRAIN_STEPS: dict(
        kind="counter", label=None,
        help="train steps dispatched through gluon.TrainLoop"),
    WINDOW_PUSHES: dict(
        kind="counter", label=None,
        help="async results pushed into any DispatchWindow"),
    WINDOW_RETIRES: dict(
        kind="counter", label=None,
        help="DispatchWindow FIFO retires (the designed blessed sync)"),
    WINDOW_ERRORS: dict(
        kind="counter", label=None,
        help="deferred async failures surfaced at a window retire"),
    WINDOW_OCCUPANCY: dict(
        kind="gauge", label=None,
        help="in-flight step futures currently outstanding"),
    WINDOW_CAPACITY: dict(
        kind="gauge", label=None,
        help="configured in-flight window bound (MXNET_INFLIGHT_STEPS)"),
    HOST_SYNCS: dict(
        kind="counter", label="kind",
        help="NDArray-level sync points by kind, process-wide across "
             "ALL threads (wait_to_read includes data-pipeline host "
             "reads on loader threads; window_retire = designed engine "
             "waits; guard.sync_counts() gives the per-thread hot-loop "
             "view)"),
    PREFETCH_BATCHES: dict(
        kind="counter", label=None,
        help="batches staged device-side by DevicePrefetcher"),
    PREFETCH_STARVATION: dict(
        kind="counter", label=None,
        help="times the consumer found the staging queue empty"),
    PREFETCH_INPUT_WAIT: dict(
        kind="counter", label=None,
        help="cumulative consumer-side wait on staged input, seconds"),
    COMPILE_CACHE_HITS: dict(
        kind="counter", label=None,
        help="persistent compilation cache hits (MXNET_COMPILE_CACHE)"),
    COMPILE_CACHE_MISSES: dict(
        kind="counter", label=None,
        help="persistent compilation cache misses"),
    COMPILE_CACHE_ENABLED: dict(
        kind="gauge", label=None,
        help="1 when the persistent compilation cache is armed"),
    COMPILE_RETRACES: dict(
        kind="counter", label=None,
        help="new compiled shape buckets built by Trainer.compile_step"),
    CHECKPOINT_SAVES: dict(
        kind="counter", label=None,
        help="checkpoints committed by TrainCheckpointManager"),
    CHECKPOINT_ERRORS: dict(
        kind="counter", label=None,
        help="failed checkpoint writes (surfaced on next save/wait)"),
    CHECKPOINT_RESTORES: dict(
        kind="counter", label=None,
        help="checkpoints applied by TrainCheckpointManager (auto-"
             "resume, elastic recovery, explicit restore)"),
    CHECKPOINT_RECOVERY_SECONDS: dict(
        kind="histogram", label=None,
        help="load+verify+apply latency of one checkpoint restore "
             "(the recovery-path critical section)"),
    ELASTIC_RECOVERIES: dict(
        kind="counter", label="cause",
        help="elastic supervisor recoveries by cause (device_lost, "
             "transient, stall, grow, preemption)"),
    ELASTIC_DOWNTIME_SECONDS: dict(
        kind="histogram", label=None,
        help="failure-to-resumed downtime of one elastic recovery "
             "(window discard + backoff + mesh re-form + recompile + "
             "restore)"),
    ELASTIC_WORLD_SIZE: dict(
        kind="gauge", label=None,
        help="devices in the currently-formed elastic world (shrinks "
             "on device loss, grows back on restore)"),
    ELASTIC_PREEMPTIONS: dict(
        kind="counter", label=None,
        help="preemption notices (SIGTERM/maintenance) that triggered "
             "a grace-window final checkpoint"),
    CHECKPOINT_CAPTURE_SECONDS: dict(
        kind="histogram", label=None,
        help="device->host state capture latency (pauses training)"),
    CHECKPOINT_SAVE_SECONDS: dict(
        kind="histogram", label=None,
        help="serialize+fsync+commit latency (overlapped, background)"),
    STEP_PHASE_SECONDS: dict(
        kind="histogram", label="phase",
        help="step-lifecycle phase durations (batch_fetch, h2d_wait, "
             "dispatch, window, retire, checkpoint)"),
    STEP_TIME_SECONDS: dict(
        kind="histogram", label=None,
        help="retire-to-retire step wall time (pipelined steady state)"),
    MODEL_FLOPS_PER_STEP: dict(
        kind="gauge", label=None,
        help="XLA cost_analysis FLOPs of one compiled train step"),
    MODEL_FLOPS_PER_SEC: dict(
        kind="gauge", label=None,
        help="flops_per_step / measured step time"),
    MFU: dict(
        kind="gauge", label=None,
        help="model FLOPs utilization vs the configured roofline"),
    STEP_TIME_EWMA: dict(
        kind="gauge", label=None,
        help="exponentially-weighted mean step time the stall detector "
             "compares against"),
    ANOMALIES: dict(
        kind="counter", label="kind",
        help="structured anomaly events by kind (nan_loss, stall, oom, "
             "memory_budget, device_lost, numerics divergence kinds)"),
    HBM_COMPILED_BYTES: dict(
        kind="gauge", label="component",
        help="compiled train-step memory_analysis bytes by component "
             "(argument, output, temp, generated_code, donated) — max "
             "over compiled shape buckets"),
    HBM_PEAK_BYTES: dict(
        kind="gauge", label=None,
        help="estimated peak HBM of one compiled train step: "
             "argument+output+temp+generated_code minus donated aliases"),
    MEM_POOL_BYTES: dict(
        kind="gauge", label="pool",
        help="live per-replica buffer bytes by census pool (params, "
             "optimizer, checkpoint, prefetch, kvcache, ndarray)"),
    MEM_POOL_BUFFERS: dict(
        kind="gauge", label="pool",
        help="live buffer count by census pool"),
    MEM_UNTRACKED_BYTES: dict(
        kind="gauge", label=None,
        help="jax.live_arrays() bytes NOT claimed by any census pool "
             "(suspected leaks / user temporaries)"),
    MEM_DEVICE_IN_USE: dict(
        kind="gauge", label="device",
        help="allocator bytes_in_use per device (live-array accounting "
             "on backends without allocator stats, e.g. XLA:CPU)"),
    MEM_DEVICE_PEAK: dict(
        kind="gauge", label="device",
        help="allocator peak_bytes_in_use per device (-1 where the "
             "backend exposes no high-water mark)"),
    MEM_DEVICE_LIMIT: dict(
        kind="gauge", label="device",
        help="allocator bytes_limit per device (-1 where unknown)"),
    MEM_BUDGET_BYTES: dict(
        kind="gauge", label=None,
        help="configured MXNET_MEMORY_BUDGET headroom bound in bytes"),
    OOM_DUMPS: dict(
        kind="counter", label=None,
        help="OOM post-mortem dump files written to "
             "MXNET_MEMORY_DUMP_DIR"),
    NUMERICS_GRAD_NORM: dict(
        kind="gauge", label=None,
        help="global L2 norm of the rescaled gradient of the last "
             "retired step (psum-composed in-program: exact under "
             "ZeRO/dp sharding)"),
    NUMERICS_PARAM_NORM: dict(
        kind="gauge", label=None,
        help="global L2 norm of the trainable parameters (fp32 masters "
             "under multi-precision) before the last retired update"),
    NUMERICS_GRAD_NORM_EWMA: dict(
        kind="gauge", label=None,
        help="exponentially-weighted mean grad norm the grad_spike "
             "detector compares against"),
    NUMERICS_UPDATE_RATIO: dict(
        kind="histogram", label=None,
        help="per-step update/weight ratio ||delta w|| / ||w|| "
             "distribution (healthy runs sit around 1e-3..1e-2)"),
    NUMERICS_LAYER_GRAD_NORM: dict(
        kind="gauge", label="param",
        help="per-parameter grad norm, top-K largest layers only "
             "(MXNET_NUMERICS=per_layer; bounded label cardinality)"),
    NUMERICS_MASTER_DRIFT: dict(
        kind="gauge", label=None,
        help="max relative drift between fp32 masters and their "
             "low-precision weight casts (ZeRO multi-precision units)"),
    NUMERICS_NONFINITE: dict(
        kind="counter", label="dtype",
        help="non-finite gradient elements observed at retires, by "
             "parameter dtype"),
    NUMERICS_DUMPS: dict(
        kind="counter", label=None,
        help="numerics post-mortem dump files written to "
             "MXNET_NUMERICS_DUMP_DIR"),
    FUSION_REGIONS: dict(
        kind="gauge", label=None,
        help="fusion kernels in the last-analyzed compiled step "
             "program (analysis/fusion.py census)"),
    FUSION_STRANDED: dict(
        kind="gauge", label=None,
        help="unfused elementwise/broadcast/convert ops stranded "
             "between two fusions above the size floor — each one two "
             "avoidable HBM round-trips per step"),
    FUSION_BOUNDARY_BYTES: dict(
        kind="gauge", label=None,
        help="intermediate bytes materialized at kernel boundaries of "
             "the last-analyzed step program (written to and re-read "
             "from HBM)"),
    FUSION_COMPUTE_BOUND: dict(
        kind="gauge", label=None,
        help="FLOP-weighted share (0-1) of kernels whose arithmetic "
             "intensity clears the measured roofline ridge point"),
    SHARDING_RESHARDS: dict(
        kind="gauge", label=None,
        help="SPMD-partitioner-inserted collectives in the last-"
             "analyzed program not implied by the declared spec, above "
             "the reshard byte floor (analysis/sharding.py)"),
    SHARDING_RESHARD_BYTES: dict(
        kind="gauge", label=None,
        help="wire bytes per step moved by implicit reshards of the "
             "last-analyzed program"),
    SHARDING_COMM_COST: dict(
        kind="gauge", label="axis",
        help="estimated per-step collective communication seconds by "
             "mesh axis (ring model over the MXNET_SHARDING_BANDWIDTH "
             "profile; '?' = unattributed groups)"),
    SHARDING_COLLECTIVE_BYTES: dict(
        kind="gauge", label="axis",
        help="ring-model wire bytes per step moved by collectives, by "
             "mesh axis"),
    SHARDING_EXPOSED_COMM: dict(
        kind="gauge", label="axis",
        help="exposed (non-overlapped) collective communication "
             "seconds per step by mesh axis, measured on the "
             "optimized-HLO schedule (analysis/overlap.py; '?' = "
             "unattributed groups)"),
    OVERLAP_FRACTION: dict(
        kind="gauge", label=None,
        help="share (0-1) of modeled collective seconds hidden behind "
             "independent compute in the last-analyzed program's "
             "schedule (0 = fully serial/exposed)"),
    KERNEL_DISPATCH: dict(
        kind="counter", label="path",
        help="Pallas kernel-layer dispatch decisions by path taken "
             "(pallas = compiled TPU kernel, interpret = kernel body "
             "under pallas interpret mode, xla = reference fallback; "
             "MXNET_PALLAS gate, docs/PERF_NOTES.md)"),
    AUTOTUNE_TRIALS: dict(
        kind="counter", label="backend",
        help="autotune candidate measurements by backend (timed = "
             "live warmup+measured executions, analytical = "
             "cost_analysis/memory model scoring; docs/PERF_NOTES.md "
             "\"Autotuner\")"),
    AUTOTUNE_CACHE_HITS: dict(
        kind="counter", label=None,
        help="autotune config-DB hits: a persisted winner replayed "
             "with zero trials (MXNET_AUTOTUNE_CACHE)"),
    AUTOTUNE_CACHE_MISSES: dict(
        kind="counter", label=None,
        help="autotune config-DB misses (mode=on searches; "
             "mode=cached falls back to the shipped defaults)"),
    AUTOTUNE_ACTIVE: dict(
        kind="gauge", label="tunable",
        help="active tuned-config info gauge: one series per applied "
             "tunable override (numeric values verbatim, choice "
             "values as their grid index)"),
    SERVING_REQUESTS: dict(
        kind="counter", label=None,
        help="inference requests submitted to any DynamicBatcher"),
    SERVING_BATCHES: dict(
        kind="counter", label=None,
        help="coalesced serving micro-batches dispatched"),
    SERVING_QUEUE_DEPTH: dict(
        kind="gauge", label=None,
        help="requests waiting to be coalesced (bounded queue + the "
             "forming batch; MXNET_SERVING_QUEUE_DEPTH caps it)"),
    SERVING_INFLIGHT: dict(
        kind="gauge", label=None,
        help="serving micro-batches in flight on the device (the "
             "batcher's DispatchWindow occupancy)"),
    SERVING_OCCUPANCY: dict(
        kind="histogram", label=None,
        help="per-micro-batch fill ratio: coalesced request rows / "
             "dispatched bucket rows (1.0 = no padding waste)"),
    SERVING_LATENCY: dict(
        kind="histogram", label=None,
        help="end-to-end request latency: submit to micro-batch "
             "retire (queueing + coalescing delay + compute)"),
    SERVING_REJECTED: dict(
        kind="counter", label="reason",
        help="requests shed at admission by reason (queue = bounded "
             "queue full, deadline = projected wait exceeds the "
             "request deadline, breaker = circuit breaker open during "
             "recovery, draining = graceful shutdown in progress, "
             "kvcache = decode KV page pool exhausted; "
             "MXNET_SERVING_SHED, docs/SERVING.md)"),
    SERVING_DEADLINE_MISSED: dict(
        kind="counter", label=None,
        help="accepted requests dropped at dequeue because their "
             "deadline expired while queued (failed with typed "
             "DeadlineExceeded, never padded/dispatched)"),
    SERVING_RETRIES: dict(
        kind="counter", label="cause",
        help="serving requests re-enqueued by the ServingSupervisor "
             "after a classified failure (device_lost = in-flight "
             "work re-dispatched post-recovery, transient = bounded "
             "backoff retry)"),
    SERVING_RECOVERIES: dict(
        kind="counter", label="cause",
        help="ServingSupervisor predictor rebuilds by failure cause "
             "(device_lost: re-formed over available_devices with AOT "
             "buckets warm-started from MXNET_COMPILE_CACHE)"),
    SERVING_BREAKER_STATE: dict(
        kind="gauge", label=None,
        help="serving circuit-breaker state: 0 closed (normal), 1 "
             "half-open (post-recovery probe), 2 open (fast-failing "
             "new submits while recovery runs)"),
    SERVING_DRAIN_SECONDS: dict(
        kind="histogram", label=None,
        help="graceful-drain duration: reject-new to queue flushed + "
             "in-flight retired + batcher closed (SIGTERM/preemption "
             "workflow, docs/SERVING.md)"),
    DECODE_TOKENS: dict(
        kind="counter", label=None,
        help="decode tokens delivered to streaming clients (useful "
             "tokens only: dropped post-EOS in-flight tokens excluded)"),
    DECODE_ACTIVE_SLOTS: dict(
        kind="gauge", label=None,
        help="batch slots occupied by a live request (prefilling or "
             "decoding) in the continuous-batching decode engine"),
    DECODE_KV_PAGES: dict(
        kind="gauge", label="state",
        help="paged-KV-cache page counts by state (used / free / "
             "shared — shared pages are mapped by >= 2 requests and "
             "counted once); bytes ride the kvcache census pool in "
             "mx_mem_pool_bytes"),
    DECODE_TTFT_SECONDS: dict(
        kind="histogram", label=None,
        help="time-to-first-token per decode request: admission to "
             "first streamed token retire (queueing + chunked prefill "
             "+ first step)"),
    DECODE_TPOT_SECONDS: dict(
        kind="histogram", label=None,
        help="time-per-output-token: inter-token gap between "
             "consecutive streamed tokens of one request (steady-state "
             "decode cadence)"),
    DECODE_SPEC_DRAFTED: dict(
        kind="counter", label=None,
        help="draft tokens proposed by the speculative-decode drafter "
             "(the guaranteed per-step token is not a draft and is "
             "excluded; acceptance rate = accepted / drafted)"),
    DECODE_SPEC_ACCEPTED: dict(
        kind="counter", label=None,
        help="draft tokens the verify scan accepted (longest prefix "
             "matching the model's own greedy continuation — the "
             "emitted stream stays bit-exact vs plain decode)"),
    DECODE_PREFIX_HITS: dict(
        kind="counter", label=None,
        help="requests seated onto shared prefix-cache pages (a "
             "registered prompt prefix matched byte-for-byte, so "
             "prefill skipped the shared region)"),
    DECODE_COW_COPIES: dict(
        kind="counter", label=None,
        help="copy-on-write page copies: a writer diverging on a "
             "shared KV page got a private copy before the write"),
    FLEET_REPLICAS: dict(
        kind="gauge", label="state",
        help="fleet replicas by lifecycle state (serving = in "
             "rotation, draining = flushing accepted requests before "
             "retire/swap, recovering = predictor rebuild after a "
             "replica loss, retired = out of the fleet for good)"),
    FLEET_ROUTED: dict(
        kind="counter", label="replica",
        help="requests the FleetRouter handed to each replica "
             "(lowest-projected-wait policy; an open breaker or a "
             "draining replica receives zero)"),
    FLEET_RESTARTS: dict(
        kind="counter", label=None,
        help="replica restarts after a replica loss (in-flight "
             "requests re-enqueued onto survivors; the dead replica "
             "rebuilt with bounded backoff on a spare device)"),
    FLEET_SWAPS: dict(
        kind="counter", label=None,
        help="zero-downtime rolling weight swaps completed "
             "(FleetController.swap_weights: drain one replica at a "
             "time, load the CRC-verified checkpoint, return to "
             "rotation)"),
    FLEET_SCALE_EVENTS: dict(
        kind="counter", label="direction",
        help="autoscale actions (up = replica added on queue-wait "
             "EWMA past MXNET_FLEET_SCALE_UP_WAIT_MS, down = emptiest "
             "replica drained-then-retired below the low-water mark)"),
    FLEET_QUEUE_WAIT: dict(
        kind="histogram", label=None,
        help="projected queue wait of the replica chosen at each "
             "routed submit — the fleet-wide load signal the "
             "autoscaler EWMAs"),
    THREADS_HELD: dict(
        kind="gauge", label=None,
        help="audited (mx_lock) locks currently held, process-wide"),
    THREADS_LONGEST_WAIT: dict(
        kind="gauge", label=None,
        help="longest single audited-lock wait observed since reset "
             "(updated live while a waiter is still blocked, so a "
             "wedged process shows its stall)"),
    THREADS_LOCK_WAIT: dict(
        kind="histogram", label="name",
        help="contended audited-lock acquisition wait per lock name"),
    THREADS_DUMPS: dict(
        kind="counter", label=None,
        help="deadlock/stall forensics dumps written to "
             "MXNET_THREADS_DUMP_DIR"),
    HEARTBEATS: dict(
        kind="counter", label=None,
        help="periodic telemetry heartbeat log lines emitted"),
}


def is_valid(name: str) -> bool:
    """Whether ``name`` matches the documented naming convention."""
    return bool(NAME_RE.match(name))


def kind_ok(name: str, kind: str) -> bool:
    """Kind-suffix rules: counters end ``_total``, histograms end in a
    unit suffix (``_seconds`` / ``_ratio``), gauges end in neither
    ``_total`` nor ``_bucket``."""
    if kind == "counter":
        return name.endswith("_total")
    if kind == "histogram":
        return name.endswith(("_seconds", "_ratio"))
    if kind == "gauge":
        return not name.endswith(("_total", "_bucket"))
    return False


def check(name: str, kind: str):
    """Registration-time validation (raises ``MXNetError``): convention
    regex + kind suffix for everyone; ``mx_``-prefixed names must also
    be declared in :data:`CATALOG` with a matching kind."""
    from ..base import MXNetError
    if not is_valid(name):
        raise MXNetError(
            f"metric name {name!r} violates the telemetry naming "
            f"convention {NAME_RE.pattern!r} (docs/OBSERVABILITY.md)")
    if not kind_ok(name, kind):
        raise MXNetError(
            f"metric {name!r} registered as {kind} violates the kind-"
            "suffix rule (counters *_total, histograms *_seconds; "
            "docs/OBSERVABILITY.md)")
    if name.startswith("mx_"):
        decl = CATALOG.get(name)
        if decl is None:
            raise MXNetError(
                f"metric {name!r} uses the framework prefix but is not "
                "declared in telemetry/names.py CATALOG — add "
                "it there (single source of truth) before registering")
        if decl["kind"] != kind:
            raise MXNetError(
                f"metric {name!r} declared as {decl['kind']} in the "
                f"catalog but registered as {kind}")
