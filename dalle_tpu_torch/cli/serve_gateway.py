"""Serving gateway: HTTP/SSE front end over a replica fleet, on the card.

Port of ``scripts/serve_gateway.py``, with its flags: N continuous-batching
replicas (``serve.DecodeEngine`` through ``DalleWithVae.serve_engine``)
behind the gateway (``gateway/``): per-tenant token-bucket quotas,
SLO-aware admission, priority/deadline scheduling, least-backlog dispatch
with mid-stream failover, graceful drain on SIGINT/SIGTERM, the SIGUSR2
profiler. The differences: ``--device`` (the CUDA card unless ``cpu``);
``--untrained`` builds the tiny random model; ``--dalle_path`` (a
``train_dalle`` checkpoint with its dVAE sidecar) and ``--clip_path`` (a
``train_clip`` checkpoint) load through the port's loaders; ``--aot_dir``
and ``--aot_export`` raise (CUDA-graph capture, ``ROADMAP.md`` Queue 1
item 2); the compilation-cache flags are not taken, as in the port's
other entry points (the kernels are cached in ``build/kernels``).

    python -m dalle_tpu_torch.cli.serve_gateway --dalle_path ./dalle_ckpt \\
        --clip_path ./clip_ckpt --replicas 2 --slots 8 --port 8080
    python -m dalle_tpu_torch.cli.serve_gateway --untrained --device cpu --port 0
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ._common import add_device_arg, install_sigusr2_profiler, unported

TINY_CFG = dict(num_text_tokens=32, text_seq_len=6, dim=64, depth=2,
                heads=2, dim_head=32, image_size=16, image_vocab_size=24,
                image_fmap_size=4)


def add_model_args(ap):
    src = ap.add_argument_group("model")
    src.add_argument("--dalle_path", type=str, default=None,
                     help="DALLE checkpoint dir (dalle_tpu_torch.cli.train_dalle)")
    src.add_argument("--untrained", action="store_true",
                     help="tiny random model (loopback smoke/demo)")
    src.add_argument("--model_seed", type=int, default=0,
                     help="--untrained init seed: every replica of one fleet "
                          "must use the same seed")
    src.add_argument("--precision", type=str, default="int8w",
                     choices=["float32", "bfloat16", "bf16_int8kv", "int8w"],
                     help="serve-engine precision (int8w: int8 weights through "
                          "the W8 kernel and an int8 KV cache)")
    add_device_arg(ap)
    return src


def add_profiler_args(ap):
    prof = ap.add_argument_group("on-demand profiler")
    prof.add_argument("--profiler_dir", type=str, default=None,
                      help="SIGUSR2 target dir for bounded torch.profiler traces "
                           "(default: profile_artifacts; 'off' disables)")
    prof.add_argument("--profiler_capture_s", type=float, default=5.0,
                      help="seconds per capture (the bound)")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = add_model_args(ap)
    src.add_argument("--clip_path", type=str, default=None,
                     help="CLIP checkpoint dir (dalle_tpu_torch.cli.train_clip) "
                          "attached as the /v1/images reranker")
    fleet = ap.add_argument_group("fleet")
    fleet.add_argument("--replicas", type=int, default=1)
    fleet.add_argument("--slots", type=int, default=4,
                       help="decode slots (device batch) per replica")
    fleet.add_argument("--steps_per_sync", type=int, default=4,
                       help="device steps per host read of the tokens")
    fleet.add_argument("--queue_maxsize", type=int, default=64,
                       help="bounded per-replica backlog; overflow → 429")
    fleet.add_argument("--prefill_chunk", type=int, default=0,
                       help="split window and trickle prefills into chunks of "
                            "this many positions (0 = one-shot prefills)")
    fleet.add_argument("--policy", type=str, default="fifo",
                       choices=["fifo", "priority_deadline"],
                       help="take-order policy (priority_deadline adds tiers, "
                            "EDF and shedding)")
    aot = ap.add_argument_group("AOT cold start (not ported: ROADMAP.md Queue 1 item 2)")
    aot.add_argument("--aot_dir", type=str, default=None)
    aot.add_argument("--aot_export", type=str, default=None)
    net = ap.add_argument_group("network / quotas")
    net.add_argument("--host", type=str, default="127.0.0.1")
    net.add_argument("--port", type=int, default=8080)
    net.add_argument("--tenant_rate", type=float, default=10.0,
                     help="default per-tenant requests/s")
    net.add_argument("--tenant_burst", type=float, default=20.0)
    net.add_argument("--tenant_override", action="append", default=[],
                     metavar="TENANT=RATE:BURST",
                     help="per-tenant quota override (repeatable)")
    ap.add_argument("--prometheus_path", type=str, default="",
                    help="node-exporter textfile target (written on drain; "
                         "live scrape is GET /metrics)")
    scope = ap.add_argument_group("telemetry")
    scope.add_argument("--flight_dir", type=str, default="flight_bundles",
                       help="flight-recorder bundle dir ('off' disables); bundles "
                            "dump on replica death, failover, SLO breach and SIGQUIT")
    scope.add_argument("--slo_objective", type=float, default=0.999,
                       help="availability objective of the burn-rate sentry")
    scope.add_argument("--usage_log", type=str, default=None,
                       help="per-tenant usage ledger (append-only JSONL with "
                            "atomic rotation)")
    scope.add_argument("--decode_health", action="store_true",
                       help="decode-quality gauges (entropy, top-k mass, repeat "
                            "ratio) per request; tokens unchanged")
    add_profiler_args(ap)
    return ap


def check_ported(args) -> None:
    for flag in ("aot_dir", "aot_export"):
        if getattr(args, flag, None):
            raise unported(f"--{flag}", "2")


def build_wrapper(args, device):
    """The DalleWithVae the replicas serve: the tiny random model, or a
    checkpoint with its dVAE sidecar."""
    from ..config import DalleConfig
    from ..models.dalle import init_dalle
    from ..models.wrapper import DalleWithVae
    from ..train.checkpoints import load_model_checkpoint
    from ._common import load_vae_sidecar
    if args.untrained:
        return DalleWithVae(init_dalle(DalleConfig(**TINY_CFG), seed=args.model_seed,
                                       device=device), None)
    if not args.dalle_path:
        raise SystemExit("provide --dalle_path or --untrained")
    model, _ = load_model_checkpoint(args.dalle_path, "DALLE", DalleConfig, init_dalle,
                                     device)
    return DalleWithVae(model, load_vae_sidecar(args.dalle_path, device))


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    install_sigusr2_profiler("profile_artifacts", args)

    from .. import obs
    from ..device import resolve_device
    from ..gateway import (AdmissionController, Gateway, Replica, ReplicaRouter,
                           SloEstimator, TenantQuotas)
    from ..serve import PriorityDeadlinePolicy
    from ..train.checkpoints import load_clip

    device = resolve_device(args.device)
    obs.configure()
    if args.flight_dir != "off":
        obs.configure_recorder(args.flight_dir, sample_interval_s=1.0)
        obs.install_signal_dump()
    dv = build_wrapper(args, device)
    if args.clip_path:
        dv.attach_rerank(load_clip(args.clip_path, device)[0])
        print(f"rerank: CLIP attached from {args.clip_path}")

    overrides = {}
    for spec in args.tenant_override:
        tenant, _, rb = spec.partition("=")
        rate, _, burst = rb.partition(":")
        overrides[tenant] = (float(rate), float(burst or rate))
    admission = AdmissionController(
        TenantQuotas(args.tenant_rate, args.tenant_burst, overrides),
        # completions observe per-request rate; backlog drains at ~rate ×
        # total slots
        SloEstimator(parallelism=args.slots * args.replicas))

    replicas = []
    for i in range(args.replicas):
        eng = dv.serve_engine(slots=args.slots, precision=args.precision,
                              steps_per_sync=args.steps_per_sync,
                              decode_health=args.decode_health,
                              prefill_chunk=args.prefill_chunk)
        rep = Replica(eng, replica_id=f"replica-{i}", maxsize=args.queue_maxsize,
                      policy=(PriorityDeadlinePolicy()
                              if args.policy == "priority_deadline" else None))
        replicas.append(rep.start())
        print(f"{rep.replica_id}: serving on {device}")

    def on_breach(verdict):
        obs.counter_add("slo.breaches_total", 1.0)
        path = obs.dump_recorder("slo_breach", extra={
            "dominating": verdict["dominating"], "windows": verdict["windows"]})
        print(f"SLO BURNING (dominating window {verdict['dominating']})"
              + (f"; bundle {path}" if path else ""), flush=True)

    gw = Gateway(ReplicaRouter(replicas), admission, host=args.host, port=args.port,
                 vae=dv.vae, clip=dv.clip,
                 slo_sentry=obs.BurnRateSentry(objective=args.slo_objective,
                                               on_breach=on_breach),
                 usage_log=args.usage_log)
    gw.start()
    print(f"gateway listening on {gw.address} ({args.replicas} replica(s) × "
          f"{args.slots} slots, policy={args.policy}, precision={args.precision})",
          flush=True)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    print("draining…", flush=True)
    gw.shutdown(drain=True)
    if args.prometheus_path:
        obs.write_textfile(args.prometheus_path, obs.metrics_snapshot())
    obs.disable_recorder()
    print("drained; bye", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
