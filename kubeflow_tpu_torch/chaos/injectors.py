"""Fault injectors: the hands of the chaos harness. A copy of the part of
``kubeflow_tpu/chaos/injectors.py`` that the serving slices need: the
engine faults :func:`wedge_engine`, :func:`drop_prefix_cache`,
:func:`slow_decode`, :func:`kill_mid_stream` and :func:`drop_kv_ship`,
and the ``kft_chaos_injected_total`` counter behind
:func:`record_injection`.

Each injector drives an *existing* seam (the engine's ``pre_chunk`` and
``kv_ship`` fault hooks, ``LMEngine.drop_prefix_cache``), so production
code carries no chaos branches.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from kubeflow_tpu_torch.obs import names, prom

logger = logging.getLogger(__name__)

CHAOS_INJECTED = prom.REGISTRY.counter(
    names.CHAOS_INJECTED_TOTAL,
    "faults injected by the chaos harness",
    labels=("kind",),
)


def record_injection(kind: str) -> None:
    CHAOS_INJECTED.labels(kind=kind).inc()


def wedge_engine(engine, *, hold_s: float = 30.0):
    """Stall the engine's NEXT device chunk dispatch: the scheduler thread
    blocks inside the pre-chunk fault hook exactly as it would inside a
    wedged device call — heartbeat stops advancing while work piles up,
    which is the watchdog's trip condition. Returns ``release()``; the
    stall also self-releases after ``hold_s`` so an un-watched engine
    cannot stay wedged forever.

    One-shot: the hook uninstalls itself after the stall, so a restarted
    (or released) engine decodes normally."""
    released = threading.Event()
    fired = threading.Event()

    def hook(eng) -> None:
        if fired.is_set():
            return
        fired.set()
        record_injection("wedge_engine")
        logger.warning(
            "chaos: wedging engine for up to %.1fs (next chunk stalled)",
            hold_s,
        )
        released.wait(hold_s)
        eng._fault_hooks.pop("pre_chunk", None)

    engine._fault_hooks["pre_chunk"] = hook
    return released.set


def drop_prefix_cache(engine) -> int:
    """Wipe the engine's stored prefix KV — the cold-cache state a fresh
    replica (or a ring remap victim) starts in. Production seam:
    ``LMEngine.drop_prefix_cache`` (lock-guarded against the scheduler
    thread and the peer-transfer routes). Returns entries dropped."""
    record_injection("drop_prefix_cache")
    dropped = engine.drop_prefix_cache()
    logger.warning(
        "chaos: dropped %d prefix-cache entries (replica is cold)", dropped
    )
    return dropped


def slow_decode(engine, *, delay_s: float = 0.05):
    """Inflate every chunk's latency by ``delay_s`` — the brownout (not
    blackout) fault: decode throughput collapses, queue-wait estimates
    grow, and deadline-aware admission control must start shedding.
    Returns ``stop()`` to remove the hook."""
    record_injection("slow_decode")

    def hook(eng) -> None:
        time.sleep(delay_s)

    engine._fault_hooks["pre_chunk"] = hook

    def stop() -> None:
        if engine._fault_hooks.get("pre_chunk") is hook:
            engine._fault_hooks.pop("pre_chunk", None)

    return stop


def kill_mid_stream(engine, *, pid: int | None = None, after_tokens: int = 1,
                    action=None):
    """Hard-kill the replica hosting ``engine`` the moment any resident
    request has emitted at least ``after_tokens`` tokens — a decode death
    with tokens already committed to a client's stream, the worst case
    for streaming (a pre-stream death just retries). The gateway's
    failover path must re-dispatch the stream to a peer with the
    committed prefix and splice the continuation invisibly.

    ``action`` overrides the kill for in-process harnesses (SIGKILLing
    the default ``pid`` — this process — would take the harness down with
    the replica); it receives the engine and typically kills the
    replica's server (``ModelServer.kill``) or raises the watchdog
    poison. The hook is one-shot and uninstalls itself before acting, so
    a restarted engine decodes normally. Returns ``stop()`` to disarm
    early."""

    def hook(eng) -> None:
        if not any(
            req is not None and len(req.tokens) >= after_tokens
            for req in eng._slots
        ):
            return
        if eng._fault_hooks.get("pre_chunk") is hook:
            eng._fault_hooks.pop("pre_chunk", None)
        record_injection("kill_mid_stream")
        logger.warning(
            "chaos: killing replica mid-stream (>= %d tokens emitted)",
            after_tokens,
        )
        if action is not None:
            action(eng)
            return
        import signal

        os.kill(pid if pid is not None else os.getpid(), signal.SIGKILL)

    engine._fault_hooks["pre_chunk"] = hook

    def stop() -> None:
        if engine._fault_hooks.get("pre_chunk") is hook:
            engine._fault_hooks.pop("pre_chunk", None)

    return stop


def drop_kv_ship(engine, *, count: int = 1):
    """Fail the engine's next ``count`` disaggregated KV-span pulls at
    the wire seam (``fetch_kv_span``'s ``kv_ship`` fault hook fires
    before the HTTP POST — the prefill peer dying mid-ship). The pull's
    fallback contract does the rest: the decode replica prefills locally
    and the client sees identical tokens. Self-uninstalls after
    ``count`` fires; returns ``stop()`` to remove it early."""
    remaining = [int(count)]

    def hook(eng) -> None:
        if remaining[0] <= 0:
            return
        remaining[0] -= 1
        record_injection("drop_kv_ship")
        logger.warning(
            "chaos: dropping KV ship (%d more to drop)", remaining[0]
        )
        if remaining[0] <= 0 and eng._fault_hooks.get("kv_ship") is hook:
            eng._fault_hooks.pop("kv_ship", None)
        raise OSError("chaos: injected KV-ship failure (peer died mid-ship)")

    engine._fault_hooks["kv_ship"] = hook

    def stop() -> None:
        if engine._fault_hooks.get("kv_ship") is hook:
            engine._fault_hooks.pop("kv_ship", None)

    return stop
