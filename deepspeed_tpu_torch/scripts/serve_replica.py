"""Run one fabric replica server process (docs/SERVING.md "Multi-host
serving"); counterpart of ``scripts/serve_replica.py``.

The process owns its own CUDA context (and its own GIL and default
stream) and serves the fabric RPC protocol
(``deepspeed_tpu_torch/serving/fabric/server.py``) for a frontend to adopt
as a :class:`RemoteHandle` replica::

    python -m deepspeed_tpu_torch.scripts.serve_replica --spec spec.json \
        [--listen 127.0.0.1:0] [--replica-id 0] [--heartbeat-s 1.0] \
        [--loopback-ok] [--device cuda|cpu]

``spec.json`` has the JAX script's format::

    {
      "model":      {... TransformerConfig kwargs ...},
      "engine":     {... RaggedInferenceEngineConfig kwargs ...},
      "seed":       0,              # weights drawn from
                                    # torch.Generator(device).manual_seed
                                    # (seed) — one seed gives one set of
                                    # weights in every port process on one
                                    # device type, but not the JAX
                                    # package's (torch cannot draw
                                    # jax.random)
      "checkpoint": null,           # OR a universal checkpoint dir (what
                                    # the JAX package's save_checkpoint
                                    # writes), loaded through runtime/
                                    # checkpointing.load_params_for_model
                                    # (overrides seed) — the way to serve
                                    # the JAX package's weights
      "model_id":   "default",      # pool name advertised in the fabric
                                    # hello (a frontend adopting this
                                    # replica under a DIFFERENT model name
                                    # refuses it: ModelMismatch)
      "mesh":       null,           # a tensor-parallel replica is not
                                    # launched yet: a spec with one exits 2
      "serving":    {... ServingConfig dict (engine blocks, speculative,
                      disaggregation/handoff chunking, faults...) ...}
    }

``--device`` defaults to ``cuda``; without a card and without ``--device
cpu`` the process exits non-zero with the port's device error.

On startup the process prints one machine-readable line::

    FABRIC_LISTENING <advertise_host>:<port>

(the parent parses it to learn an ephemeral port; the advertised host is
the host's routable IP unless the bind address was explicit or
``--loopback-ok`` is given). On a clean stop (SIGTERM or SIGINT) it prints
one more::

    FABRIC_KERNELS {"paged_attention": n, "quantize": n,
                    "quantized_matmul": n, "dequantize": n, "puts": n}

the kernel wrappers' launch counts in this process and the engine puts
that ran here, then::

    FABRIC_HANDOFF {"export": {uid: [t0, t1], ...}, "import": {...}}

the ``time.monotonic()`` span of every KV export and import this process
ran (one clock for every process of a host). Nothing on the wire changes
for either.
"""

import argparse
import json
import signal
import sys
import time

KERNELS_TAG = "FABRIC_KERNELS"
HANDOFF_TAG = "FABRIC_HANDOFF"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", required=True, help="spec JSON path")
    ap.add_argument("--listen", default="127.0.0.1:0")
    ap.add_argument("--replica-id", type=int, default=0)
    ap.add_argument("--heartbeat-s", type=float, default=1.0)
    ap.add_argument("--loopback-ok", action="store_true",
                    help="advertise the literal bind host even if it is "
                         "loopback (single-host tests/bench)")
    ap.add_argument("--device", default="cuda",
                    help="device the engine runs on (cuda or cpu)")
    args = ap.parse_args(argv)

    with open(args.spec) as fh:
        spec = json.load(fh)
    if spec.get("mesh"):
        print(f"serve_replica: mesh spec {spec['mesh']} refused: a "
              "tensor-parallel replica is a group of processes (a leader "
              "and its tensor followers), which deepspeed_tpu_torch does "
              "not launch yet (ROADMAP.md queue 1 item 14b-ii)",
              file=sys.stderr)
        return 2

    from deepspeed_tpu_torch import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve_replica: {e}", file=sys.stderr)
        return 1

    from deepspeed_tpu_torch.inference.v2.engine_v2 import (
        InferenceEngineV2, RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.ops import paged_attention, quantizer
    from deepspeed_tpu_torch.serving.config import ModelSpec, ServingConfig
    from deepspeed_tpu_torch.serving.fabric.server import ReplicaServer
    from deepspeed_tpu_torch.serving.fabric.transport import \
        advertised_address
    from deepspeed_tpu_torch.serving.frontend import model_from_spec

    mspec = ModelSpec(model=spec["model"], engine=spec.get("engine", {}),
                      seed=int(spec.get("seed", 0)),
                      checkpoint=spec.get("checkpoint"))
    model, params, device = model_from_spec(mspec, device)
    # the first engine takes this tree over; a reset draws (or loads) the
    # same weights again, so no dense tree outlives the engine holding it
    # (a weight-quantized engine keeps only its quantized tree)
    first = [params]
    del params
    puts = [0]
    spans = {"export": {}, "import": {}}

    def engine_factory():
        p = first.pop() if first else model_from_spec(mspec, device)[1]
        eng = InferenceEngineV2(
            model, params=p,
            config=RaggedInferenceEngineConfig(**mspec.engine),
            device=device)
        put = eng.put

        def counted_put(*a, **kw):
            puts[0] += 1        # only the replica's worker thread puts
            return put(*a, **kw)

        eng.put = counted_put
        for name in spans:
            real = getattr(eng, f"{name}_sequence")

            def timed(uid, *a, _real=real, _name=name, **kw):
                t0 = time.monotonic()
                out = _real(uid, *a, **kw)
                spans[_name][str(uid)] = [t0, time.monotonic()]
                return out

            setattr(eng, f"{name}_sequence", timed)
        return eng

    config = ServingConfig(**spec.get("serving", {}))
    server = ReplicaServer(engine_factory, config, listen=args.listen,
                           replica_id=args.replica_id,
                           heartbeat_s=args.heartbeat_s,
                           max_frame_bytes=config.fabric.max_frame_bytes,
                           model_id=str(spec.get("model_id", "default")))
    signal.signal(signal.SIGTERM, lambda *_: server._stop.set())
    host = (server.listen_host if args.loopback_ok
            else advertised_address(server.listen_host,
                                    server.port).rsplit(":", 1)[0])
    print(f"FABRIC_LISTENING {host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    q = quantizer.launches
    print(f"{KERNELS_TAG} " + json.dumps(
        {"paged_attention": paged_attention.launches,
         "quantize": q["quantize"],
         "quantized_matmul": q["quantized_matmul"],
         "dequantize": q["dequantize"], "puts": puts[0]}), flush=True)
    print(f"{HANDOFF_TAG} " + json.dumps(spans), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
