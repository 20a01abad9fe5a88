"""Run one federated serving frontend process (docs/SERVING.md "Frontend
federation"); counterpart of ``scripts/serve_frontend.py``.

The process builds a :class:`ServingFrontend` over local engines that
share one weight tree and — when the spec's serving config enables
``fabric.federation`` with ``fabric.listen`` — exports its replica pool to
peer frontends. Peers adopt the exports as routable federated members;
killing this process exercises the cross-frontend failover path on every
peer::

    python -m deepspeed_tpu_torch.scripts.serve_frontend --spec spec.json \
        [--device cuda|cpu]

``spec.json``::

    {
      "model":      {... TransformerConfig kwargs ...},
      "engine":     {... RaggedInferenceEngineConfig kwargs ...},
      "seed":       0,              # torch.Generator(device).manual_seed
      "checkpoint": null,           # OR a universal checkpoint dir
      "n_replicas": 1,              # local engines behind this frontend
      "serving":    {... ServingConfig dict; federation topology lives
                      in its fabric block: "fabric": {"enabled": true,
                      "listen": "127.0.0.1:0", "federation":
                      {"enabled": true, "peers": [...]}} ...}
    }

One seed (or one checkpoint) gives every port process the same weights on
one device type, so greedy streams match to the token whichever
frontend's replica served them. ``--device`` defaults to ``cuda``; without
a card and without ``--device cpu`` the process exits non-zero.

On startup the process prints one machine-readable line::

    FEDERATION_LISTENING <host>:<port>

(``none`` when the spec does not export). It serves until SIGTERM or
SIGINT.
"""

import argparse
import json
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", required=True, help="spec JSON path")
    ap.add_argument("--device", default="cuda",
                    help="device the engines run on (cuda or cpu)")
    args = ap.parse_args(argv)

    with open(args.spec) as fh:
        spec = json.load(fh)
    if spec.get("mesh"):
        print(f"serve_frontend: mesh spec {spec['mesh']} refused: a "
              "tensor-parallel replica is a group of processes (a leader "
              "and its tensor followers), which deepspeed_tpu_torch does "
              "not launch yet (ROADMAP.md queue 1 item 14b-ii)",
              file=sys.stderr)
        return 2

    from deepspeed_tpu_torch import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve_frontend: {e}", file=sys.stderr)
        return 1

    from deepspeed_tpu_torch.inference.v2.engine_v2 import (
        InferenceEngineV2, RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.serving.config import ModelSpec, ServingConfig
    from deepspeed_tpu_torch.serving.frontend import (ServingFrontend,
                                                      model_from_spec)

    mspec = ModelSpec(model=spec["model"], engine=spec.get("engine", {}),
                      seed=int(spec.get("seed", 0)),
                      checkpoint=spec.get("checkpoint"))
    model, params, device = model_from_spec(mspec, device)
    engines = [
        InferenceEngineV2(
            model, params=params,
            config=RaggedInferenceEngineConfig(**mspec.engine),
            device=device)
        for _ in range(int(spec.get("n_replicas", 1)))]
    del params

    config = ServingConfig(**spec.get("serving", {}))
    fe = ServingFrontend(engines, config)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    addr = fe.federation_address
    print(f"FEDERATION_LISTENING {addr or 'none'}", flush=True)
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        fe.shutdown(drain=False, timeout=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
