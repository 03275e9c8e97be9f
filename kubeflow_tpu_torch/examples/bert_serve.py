"""kserve-bert on one card: a BERT predictor behind the port's
``ModelServer`` (the port of ``kubeflow_tpu/examples/bert_serve.py``).

Point ``--model-dir`` at an HF-format directory (``config.json`` +
``pytorch_model.bin`` + ``vocab.txt``), a port checkpoint, or nothing for
random bert-base weights (latency-representative):

    python -m kubeflow_tpu_torch.examples.bert_serve [--model-dir D] \\
        [--tiny] [--device cpu] [--port 8080]
    curl -d '{"instances": ["the capital of france is [MASK]."]}' \\
        localhost:8080/v1/models/bert:predict
    curl -d '{"inputs": [{"name": "input_ids", "shape": [1, 4],
                          "datatype": "INT32", "data": [101, 7, 8, 102]}]}' \\
        localhost:8080/v2/models/bert/infer

Loading fails closed: a directory that cannot be loaded stops the
program before it serves. The device is the CUDA card unless ``--device
cpu`` asks for the CPU, where attention runs the flash kernel's plain
PyTorch twin; nothing switches device or attention on its own.
"""

from __future__ import annotations

import argparse
import threading


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", type=str, default=None,
                   help="HF-format dir (config.json + pytorch_model.bin + "
                        "vocab.txt) or a port checkpoint")
    p.add_argument("--name", type=str, default="bert")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--tiny", action="store_true",
                   help="bert-tiny config (CPU-friendly smoke runs)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card")
    args = p.parse_args(argv)

    from kubeflow_tpu_torch.models.bert import bert_base, bert_tiny
    from kubeflow_tpu_torch.serve.runtimes import BertRuntimeModel
    from kubeflow_tpu_torch.serve.server import ModelServer

    cfg = None
    if args.tiny:
        cfg = bert_tiny()
    elif args.model_dir is None:
        cfg = bert_base()
    # else: the config comes from the model dir's config.json
    model = BertRuntimeModel(args.name, args.model_dir, config=cfg,
                             device=args.device)
    model.load()  # fail closed: a bad --model-dir stops here, not mid-request
    server = ModelServer([model], http_port=args.port, host=args.host).start()
    print(f"serving {args.name!r} on {args.host}:{server.port} "
          f"(device={model.module.device}, "
          f"tokenizer={type(model.tokenizer).__name__})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
