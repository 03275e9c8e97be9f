#!/usr/bin/env python3
"""Where a load-harness replica's time goes, on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 scripts/chip_load_breakdown.py [--out FILE]

``chip_smoke.py --phases load`` serves ``bench_serving_load``'s traffic
through the port's ``run_serving_load``: full-width bf16 replicas with
the JAX harness's engine shape (4 rows, 2-step chunks, one 32-token
prefill bucket, a 32-entry prefix cache) on the paged kernel, behind the
gateway, an autoscaler and an open-loop client, all in one process. This
script takes that stack apart, one layer at a time, on the mix's first
16 requests (seed 7; 6 or 10 prompt tokens, 4 or 8 new):

- ``engine``: one replica's engine, ``submit`` called by this thread,
  one request at a time, with and without a sampling seed, at the
  harness's shape, at 8-step chunks, and at the serving cell's (8 rows,
  8-step chunks); then 4 at once on 4 threads;
- ``http``: the same requests over ``generate_stream`` to the replica's
  ``ModelServer``, one at a time, with the gateway's seed header;
- ``gateway``: through the port's ``InferenceGateway`` to that replica;
- ``busy_peer``: through the gateway while a second replica in this
  process decodes a stream of its own the whole time (one interpreter
  for both engine loops);
- ``profile``: ``torch.profiler`` over 4 of the engine's seeded
  requests: device busy share of the wall and the top kernels.

Each line gives ms a request (median, least, most) and ms a generated
token, and for the engine rows its chunk count and decode-gap EWMA.
Then the card's name and power limit. ``--out`` also writes the lines to
a file.
"""

from __future__ import annotations

import argparse
import http.client
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (MODEL, ENGINE, load_configs)

LINES: list[dict] = []


def emit(obj: dict) -> None:
    LINES.append(obj)
    print(json.dumps(obj), flush=True)


def _stats(ms: list[float], tokens: int) -> dict:
    return {"ms_median": statistics.median(ms), "ms_min": min(ms),
            "ms_max": max(ms), "requests": len(ms), "tokens": tokens,
            "ms_per_token": sum(ms) / max(tokens, 1)}


def _model(torch, name="m", **engine):
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serve.engine import LMEngineModel
    from kubeflow_tpu_torch.serve.model import BucketSpec

    kw = dict(max_batch=4, chunk_steps=2, prefix_cache_entries=32,
              kv_pool_tokens=cs.ENGINE["kv_pool_tokens"],
              page_size=cs.ENGINE["page_size"], paged_attn_impl="kernel")
    kw.update(engine)
    cfg = TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", **cs.MODEL)
    m = LMEngineModel(name, config=cfg, device="cuda", watchdog=False,
                      buckets=BucketSpec(batch_sizes=(1,), seq_lens=(32,)),
                      max_new_tokens=12, eos_id=cfg.vocab_size + 1, **kw)
    m.load()
    return m


def _engine_rows(torch, specs):
    for label, kw in (("harness", {}), ("chunk8", dict(chunk_steps=8)),
                      ("serving_cell", dict(max_batch=8, chunk_steps=8))):
        m = _model(torch, **kw)
        eng = m.engine
        for seeded in (False, True):
            c0 = eng.stats["chunks"]
            ms, toks = [], 0
            for s in specs:
                t0 = time.perf_counter()
                out = eng.submit(list(s.prompt_ids), max_new_tokens=s.max_new_tokens,
                                 seed=1 if seeded else None)
                ms.append((time.perf_counter() - t0) * 1e3)
                toks += len(out)
            emit({"row": "engine", "shape": label, "seeded": seeded,
                  **_stats(ms, toks), "chunks": eng.stats["chunks"] - c0,
                  "decode_gap_ms_ewma": eng.overlap["decode_gap_ms"]})
        res, t0 = [], time.perf_counter()

        def one(s):
            res.append(len(eng.submit(list(s.prompt_ids),
                                      max_new_tokens=s.max_new_tokens, seed=1)))
        for i in range(0, len(specs), 4):
            ts = [threading.Thread(target=one, args=(s,)) for s in specs[i:i + 4]]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
        wall = (time.perf_counter() - t0) * 1e3
        emit({"row": "engine_4_at_once", "shape": label, "wall_ms": wall,
              "tokens": sum(res), "tokens_per_s": sum(res) / wall * 1e3})
        m.unload()
        del m
        torch.cuda.empty_cache()


def _stream(port, s, headers):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v2/models/m/generate_stream", body=json.dumps(
            {"input_ids": list(s.prompt_ids), "max_new_tokens": s.max_new_tokens}),
            headers=headers)
        body = conn.getresponse().read().decode()
    finally:
        conn.close()
    return sum(len(json.loads(line[6:]).get("token_ids", ()))
               for line in body.splitlines() if line.startswith("data: "))


def _http_rows(torch, specs):
    from kubeflow_tpu_torch.gateway import GatewayConfig, InferenceGateway, ServiceRoute
    from kubeflow_tpu_torch.serve.server import ModelServer

    def run(label, port, extra=None):
        ms, toks = [], 0
        for s in specs:
            t0 = time.perf_counter()
            toks += _stream(port, s, {"x-kft-seed": "1"})
            ms.append((time.perf_counter() - t0) * 1e3)
        emit({"row": label, **_stats(ms, toks), **(extra or {})})

    a = ModelServer([_model(torch)], http_port=0).start()
    gw = InferenceGateway(GatewayConfig(routes=[ServiceRoute(name="m")], backends=[
        ("m", f"http://127.0.0.1:{a.port}", "default", "both")])).start()
    try:
        run("http", a.port)
        run("gateway", gw.http_port)
        b = ModelServer([_model(torch, name="m")], http_port=0).start()
        stop = threading.Event()
        peer_tokens = [0]

        def peer():  # the second replica decodes the whole time
            while not stop.is_set():
                peer_tokens[0] += _stream(b.port, specs[1], {"x-kft-seed": "2"})
        th = threading.Thread(target=peer, daemon=True)
        th.start()
        try:
            run("busy_peer", gw.http_port)
        finally:
            stop.set()
            th.join(120)
            b.stop()
        LINES[-1]["peer_tokens"] = peer_tokens[0]
    finally:
        gw.stop()
        a.stop()
    torch.cuda.empty_cache()


def _profile_row(torch, specs):
    from torch.profiler import ProfilerActivity, profile

    m = _model(torch)
    eng = m.engine
    for s in specs[:2]:  # warm
        eng.submit(list(s.prompt_ids), max_new_tokens=s.max_new_tokens, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        toks = sum(len(eng.submit(list(s.prompt_ids), max_new_tokens=s.max_new_tokens,
                                  seed=1)) for s in specs[:4])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    n, busy, top = cs._device_summary(prof)
    emit({"row": "profile", "wall_ms": wall, "tokens": toks, "kernels": n,
          "kernels_per_token": n / max(toks, 1), "busy_ms": busy,
          "busy_share": busy / wall,
          "top": [[k, c, round(t, 3)] for k, (c, t) in top[:8]]})
    m.unload()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_load_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.ops import _build

    _build.build()
    specs = cs.load_configs(torch)["steady"].mix.plan(16)
    _engine_rows(torch, specs)
    _http_rows(torch, specs)
    _profile_row(torch, specs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"card": card})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in LINES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
