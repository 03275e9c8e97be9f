"""Fault injectors: the hands of the chaos harness. A copy of the part of
``kubeflow_tpu/chaos/injectors.py`` that the serving slice needs:
:func:`kill_mid_stream` and the ``kft_chaos_injected_total`` counter
behind :func:`record_injection`.

Each injector drives an *existing* seam (here the engine's ``pre_chunk``
fault hook), so production code carries no chaos branches.
"""

from __future__ import annotations

import logging
import os

from kubeflow_tpu_torch.obs import names, prom

logger = logging.getLogger(__name__)

CHAOS_INJECTED = prom.REGISTRY.counter(
    names.CHAOS_INJECTED_TOTAL,
    "faults injected by the chaos harness",
    labels=("kind",),
)


def record_injection(kind: str) -> None:
    CHAOS_INJECTED.labels(kind=kind).inc()


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
