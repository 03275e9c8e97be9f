"""Request/response logger: CloudEvents-style records to a sink. A copy
of ``kubeflow_tpu/serve/logger.py``.

Reference analog: KServe's logger agent sidecar ([kserve] pkg/logger/ —
UNVERIFIED, mount empty, SURVEY.md §0) emitting request/response CloudEvents
to a configured sink URL. Here the sink is pluggable (in-memory list, JSONL
file, or a callable posting to a collector). The port's server logs from
its handler threads; each sink call is one ``list.append`` or one line
written, so events never interleave within a record.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Any, Callable

from kubeflow_tpu_torch.obs import trace


def _json_fallback(obj: Any):
    if hasattr(obj, "tolist"):  # numpy arrays and scalars
        return obj.tolist()
    return str(obj)


class RequestLogger:
    def __init__(self, sink: Callable[[dict], None] | str | None = None):
        self.entries: list[dict] = []
        self._file = None
        self._file_lock = threading.Lock()
        if isinstance(sink, str):
            self._file = open(sink, "a", buffering=1)
            self._sink: Callable[[dict], None] = self._write_file
        elif sink is not None:
            self._sink = sink
        else:
            self._sink = self.entries.append

    def _write_file(self, event: dict) -> None:
        # v2 named-tensor payloads carry numpy arrays; a JSONL sink must not
        # 500 every request over them
        line = json.dumps(event, default=_json_fallback) + "\n"
        with self._file_lock:  # one handler thread a line
            self._file.write(line)

    def _emit(self, event_type: str, model: str, req_id: str, payload: Any) -> None:
        event = {
            # CloudEvents v1.0 envelope attributes
            "specversion": "1.0",
            "id": str(uuid.uuid4()),
            "source": f"kubeflow-tpu/serve/{model}",
            "type": event_type,
            # CloudEvents event stamps are wall-clock by contract
            # (consumers correlate them across hosts); this value is never
            # subtracted from another stamp
            "time": time.time(),
            "inferenceserviceid": model,
            "requestid": req_id,
            "data": payload,
        }
        ids = trace.current_ids()
        if ids is not None:
            # `grep trace_id` across replica logs reconstructs a request
            event["trace_id"], event["span_id"] = ids
        self._sink(event)

    def log_request(self, model: str, req_id: str, payload: Any) -> None:
        self._emit("org.kubeflow.serving.inference.request", model, req_id, payload)

    def log_response(self, model: str, req_id: str, payload: Any) -> None:
        self._emit("org.kubeflow.serving.inference.response", model, req_id, payload)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
