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

#: histogram{model} — server-side time-to-first-token, milliseconds
#: (engine enqueue → first token on the host)
SERVER_TTFT_MS = "kft_server_ttft_ms"
#: histogram{model} — server-side mean time-per-output-token after the
#: first, milliseconds
SERVER_TPOT_MS = "kft_server_tpot_ms"
