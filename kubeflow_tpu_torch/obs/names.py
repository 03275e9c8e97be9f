"""The exposition names the port emits, copied letter for letter from
``kubeflow_tpu/obs/names.py`` so dashboards and scrapers keyed to the JAX
replica read a torch replica unchanged. Only the names the port exposes
are here; the rest arrive with the modules that emit them."""

from __future__ import annotations

# -- training ----------------------------------------------------------- #

#: gauges — the hot-loop overlap split (train/prefetch.py, train/metrics.py)
TRAIN_DATA_STALL_MS = "kubeflow_tpu_train_data_stall_ms"
TRAIN_H2D_MS = "kubeflow_tpu_train_h2d_ms"
TRAIN_DEVICE_STEP_MS = "kubeflow_tpu_train_device_step_ms"
TRAIN_COMPILE_MS = "kubeflow_tpu_train_compile_ms"
TRAIN_STEPS_PER_SEC = "kubeflow_tpu_train_steps_per_sec"

# -- serving ------------------------------------------------------------ #

#: gauge{model} — requests currently executing in the server
SERVER_INFLIGHT = "kft_server_inflight"
#: gauge{model} — instances waiting in the batcher queue
SERVER_QUEUE_DEPTH = "kft_server_queue_depth"
#: gauges{model} — batcher occupancy (``serve/batcher.py``)
BATCHER_BATCHES = "kubeflow_tpu_batcher_batches"
BATCHER_INSTANCES = "kubeflow_tpu_batcher_instances"
BATCHER_MEAN_OCCUPANCY = "kubeflow_tpu_batcher_mean_occupancy"
#: gauge{model} — co-batched failures re-run per caller (offender isolation)
BATCHER_FAIL_ISOLATIONS = "kubeflow_tpu_batcher_fail_isolations"
#: server request metrics (ModelServer /metrics exposition)
REQUESTS_TOTAL = "kubeflow_tpu_requests_total"
LATENCY_P50_MS = "kubeflow_tpu_latency_p50_ms"
LATENCY_P99_MS = "kubeflow_tpu_latency_p99_ms"
#: continuous-batching engine gauges; per-key stats fan out under the
#: prefixes (scheduler stats, paged-KV pool pressure)
ENGINE_ACTIVE_ROWS = "kubeflow_tpu_engine_active_rows"
ENGINE_PREFIX = "kubeflow_tpu_engine_"
ENGINE_KV_PREFIX = "kubeflow_tpu_engine_kv_"
#: pipelined-decode overlap gauges (serve/engine.py ``overlap``)
ENGINE_DECODE_GAP_MS = "kft_engine_decode_gap_ms"
ENGINE_D2H_DRAIN_MS = "kft_engine_d2h_drain_ms"
ENGINE_CARRY_UPLOADS_TOTAL = "kft_engine_carry_uploads_total"
ENGINE_SLOT_OCCUPANCY = "kft_engine_slot_occupancy"
#: prefix-cache effectiveness
ENGINE_PREFIX_HITS_TOTAL = "kft_engine_prefix_hits_total"
ENGINE_PREFIX_TOKENS_REUSED_TOTAL = "kft_engine_prefix_tokens_reused_total"
ENGINE_PREFIX_ENTRIES = "kft_engine_prefix_entries"
ENGINE_PREFIX_TOKENS_STORED = "kft_engine_prefix_tokens_stored"
#: cross-replica prefix-KV transfer: entries imported from / exported to
#: a peer replica
ENGINE_PREFIX_IMPORTED_TOTAL = "kft_engine_prefix_imported_total"
ENGINE_PREFIX_EXPORTED_TOTAL = "kft_engine_prefix_exported_total"
#: disaggregated prefill/decode: counter{model,direction} — bytes of
#: per-request KV spans shipped (export on the prefill replica, import
#: on the decode replica); histogram — one ship leg end to end, ms
ENGINE_KV_SHIP_BYTES_TOTAL = "kft_engine_kv_ship_bytes_total"
ENGINE_KV_SHIP_MS = "kft_engine_kv_ship_ms"
#: host-RAM KV tier: gauge{model} — encoded KV bytes resident, and the
#: swapped-out session rows resident
ENGINE_KV_OFFLOAD_BYTES = "kft_engine_kv_offload_bytes"
ENGINE_KV_OFFLOAD_RESIDENT_ROWS = "kft_engine_kv_offload_resident_rows"
#: speculative decoding: drafts proposed / accepted, EWMA acceptance
ENGINE_SPEC_PROPOSED_TOTAL = "kft_engine_spec_proposed_total"
ENGINE_SPEC_ACCEPTED_TOTAL = "kft_engine_spec_accepted_total"
ENGINE_SPEC_ACCEPTANCE = "kft_engine_spec_acceptance"
#: int8 KV-cache quantization: EWMA of the mean-abs relative
#: quantization error measured at prefill writes
ENGINE_KV_QUANT_ERROR = "kft_engine_kv_quant_error"
#: gauge — 1 while the engine's paged read path runs the CUDA kernel
#: (``paged_attn_impl="kernel"``), 0 for the gather
ENGINE_PAGED_ATTN_KERNEL = "kft_engine_paged_attn_kernel"

# -- serving SRE layer (serve/deadline.py, serve/watchdog.py) ------------ #

#: counter{stage} — requests retired because their end-to-end deadline
#: expired (admission / queued / decoding / wait)
ENGINE_DEADLINE_EXPIRED_TOTAL = "kft_engine_deadline_expired_total"
#: counter{reason} — requests shed by deadline-aware admission control
#: (deadline_unmeetable / priority_evict) before costing a decode slot
ENGINE_ADMISSION_SHED_TOTAL = "kft_engine_admission_shed_total"
#: counter{model,reason} — engine watchdog trips (wedged / loop_dead /
#: fatal); each trip flips readiness and triggers a supervised restart
ENGINE_WATCHDOG_TRIPS_TOTAL = "kft_engine_watchdog_trips_total"
#: counter{model} — supervised engine restarts (device state rebuilt)
ENGINE_RESTARTS_TOTAL = "kft_engine_restarts_total"

# -- request latency ----------------------------------------------------- #

#: histogram{model} — server-side time-to-first-token of traced requests,
#: milliseconds (engine enqueue → first token on the host)
SERVER_TTFT_MS = "kft_server_ttft_ms"
#: histogram{model} — server-side mean time-per-output-token after the
#: first, milliseconds
SERVER_TPOT_MS = "kft_server_tpot_ms"

# -- request tracing (obs/trace.py) -------------------------------------- #

#: counter{decision} — tail-sampler verdicts on finished traces
#: (error / slow / sampled / dropped); error+slow+sampled are retained
TRACE_SAMPLER_DECISIONS_TOTAL = "kft_trace_sampler_decisions_total"

# -- inference gateway (gateway/) --------------------------------------- #

#: counter{service,code} — requests answered at the edge, by HTTP status
GATEWAY_REQUESTS_TOTAL = "kft_gateway_requests_total"
#: histogram{service} — edge-observed request latency (activator queue
#: time included: the client experienced it)
GATEWAY_LATENCY_SECONDS = "kft_gateway_latency_seconds"
#: gauge{service} — requests parked in the activator FIFO right now
GATEWAY_QUEUE_DEPTH = "kft_gateway_queue_depth"
#: counter{service,reason} — requests shed at the edge
#: (rate_limit / inflight_cap / queue_full / activation_timeout / no_backend)
GATEWAY_SHED_TOTAL = "kft_gateway_shed_total"
#: counter{service} — transparent re-dispatches after a backend failure
GATEWAY_RETRIES_TOTAL = "kft_gateway_retries_total"
#: counter{service} — hedged second requests dispatched
GATEWAY_HEDGES_TOTAL = "kft_gateway_hedges_total"
#: counter{service} — requests routed by prefix/session affinity
GATEWAY_AFFINITY_ROUTED_TOTAL = "kft_gateway_affinity_routed_total"
#: gauge{backend} — 1 while the backend's circuit breaker is open/half-open
GATEWAY_BREAKER_OPEN = "kft_gateway_breaker_open"
#: counter{backend} — closed→open breaker transitions
GATEWAY_BREAKER_OPENS_TOTAL = "kft_gateway_breaker_opens_total"
#: gauge{service} — backends currently eligible for selection
GATEWAY_BACKENDS_READY = "kft_gateway_backends_ready"
#: counter{service} — scale-from-zero kicks issued by the activator
GATEWAY_ACTIVATIONS_TOTAL = "kft_gateway_activations_total"
#: gauge{service} — activator FIFO depth under its autoscaler-facing name
GATEWAY_ACTIVATOR_QUEUE_DEPTH = "kft_gateway_activator_queue_depth"
#: gauge{service} — 1 while a cold-episode scale-up kick is outstanding
GATEWAY_ACTIVATOR_COLD_EPISODE = "kft_gateway_activator_cold_episode"
#: counter{service,outcome} — mid-stream failovers: a decode stream whose
#: upstream died after bytes were committed, re-dispatched to a healthy
#: peer with the x-kft-resume-tokens contract (outcome: ok /
#: budget_exhausted / no_backend / failed)
GATEWAY_STREAM_RESUMES_TOTAL = "kft_gateway_stream_resumes_total"

# -- serving autoscaler (autoscale/) ------------------------------------ #

#: gauge{service} — the recommender's current desired replica count
AUTOSCALER_DESIRED_REPLICAS = "kft_autoscaler_desired_replicas"
#: gauge{service} — stable-window average observed concurrency
AUTOSCALER_STABLE_CONCURRENCY = "kft_autoscaler_stable_concurrency"
#: gauge{service} — panic-window average observed concurrency
AUTOSCALER_PANIC_CONCURRENCY = "kft_autoscaler_panic_concurrency"
#: gauge{service} — 1 while the service is in panic mode (no scale-down)
AUTOSCALER_PANIC_MODE = "kft_autoscaler_panic_mode"
#: counter{service,direction} — actuated replica-count changes (up/down)
AUTOSCALER_SCALE_EVENTS_TOTAL = "kft_autoscaler_scale_events_total"
#: counter{service} — prefix-KV entries moved between replicas after a
#: hash-ring remap (scale-up pull / scale-down evacuation)
AUTOSCALER_KV_TRANSFERS_TOTAL = "kft_autoscaler_kv_transfers_total"
#: gauge{service} — replicas a fleet currently runs (the actuated count,
#: as opposed to the recommender's desired count above)
FLEET_REPLICAS = "kft_fleet_replicas"

# -- load harness (loadgen/) --------------------------------------------- #

#: counter{tenant,outcome} — client-side verdict on every loadgen request
#: (completed_in_slo / completed_late / shed / error)
LOADGEN_REQUESTS_TOTAL = "kft_loadgen_requests_total"

# -- chaos harness (chaos/injectors.py) ---------------------------------- #

#: counter{kind} — faults the chaos harness injected
CHAOS_INJECTED_TOTAL = "kft_chaos_injected_total"
