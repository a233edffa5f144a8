"""Standalone serving replica: one engine + queue behind the fleet RPC.

Port of ``scripts/serve_replica.py``, with its flags and its handshake: a
process hosting one continuous-batching ``DecodeEngine`` and its
``PolicyQueue`` (``gateway.Replica``) served over the length-prefixed
frame protocol (``fleet/transport.py``, byte-compatible with the JAX
package's). A gateway dials it through ``RemoteReplica``; the fleet
controller spawns, drains and kills it (``fleet/manager.py``).

The handshake is one JSON line on stdout once the socket listens:

  {"fleet_replica": 1, "addr": "127.0.0.1:PORT", "pid": .., "replica_id": ..,
   "slots": .., "aot_loaded": false, "aot_refusal": null, "warmed": ..,
   "backend_compiles": ..}

``backend_compiles`` counts the kernel builds and loads of this process.
A ``DALLE_CHAOS_PLAN`` environment plan (``chaos/``) is installed on entry
and fires at the engine's decode-step boundaries (kill, hang, slow, wedge);
``--wedge_timeout_s`` arms the ``WedgeWatchdog`` over the engine's progress
counter. ``--flight_dir`` configures a flight recorder, ``--telemetry_dir``
a telemetry exporter, SIGUSR2 the profiler; SIGTERM drains gracefully.
The differences from the JAX script are those of ``serve_gateway``:
``--device``, ``--untrained`` and ``--dalle_path`` through the port's
model and loader, ``--aot_dir`` raising (``ROADMAP.md`` Queue 1 item 2),
no compilation-cache flags.

    python -m dalle_tpu_torch.cli.serve_replica --untrained --device cpu --port 0
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

from ._common import install_sigusr2_profiler
from .serve_gateway import add_model_args, add_profiler_args, build_wrapper, check_ported


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(ap)
    eng = ap.add_argument_group("engine")
    eng.add_argument("--slots", type=int, default=4)
    eng.add_argument("--steps_per_sync", type=int, default=4)
    eng.add_argument("--queue_maxsize", type=int, default=64)
    eng.add_argument("--prefill_chunk", type=int, default=0)
    eng.add_argument("--kv_block_tokens", type=int, default=0,
                     help="paged KV: > 0 swaps the dense per-slot slab for a block "
                          "pool with radix prefix reuse (exclusive with "
                          "--prefill_chunk)")
    eng.add_argument("--kv_pool_blocks", type=int, default=None,
                     help="paged pool size in blocks (default slots × blocks a slot)")
    eng.add_argument("--no_radix_cache", dest="radix_cache", action="store_false",
                     help="disable the radix prefix cache of the paged engine")
    eng.add_argument("--policy", type=str, default="fifo",
                     choices=["fifo", "priority_deadline"])
    eng.add_argument("--decode_health", action="store_true",
                     help="decode-quality gauges, exposed through the health verb "
                          "(the controller's drain-on-degradation signal)")
    eng.add_argument("--wedge_timeout_s", type=float, default=0.0,
                     help="a busy engine whose iteration counter freezes this long "
                          "self-reports unhealthy (reason wedged) through the "
                          "health verb; 0 disables. Set above the longest "
                          "legitimate dispatch (the first one builds the kernels)")
    aot = ap.add_argument_group("AOT cold start (not ported: ROADMAP.md Queue 1 item 2)")
    aot.add_argument("--aot_dir", type=str, default=None)
    aot.add_argument("--warmup", action="store_true",
                     help="serve one self-request before the handshake")
    net = ap.add_argument_group("network")
    net.add_argument("--host", type=str, default="127.0.0.1")
    net.add_argument("--port", type=int, default=0,
                     help="0 = ephemeral (the handshake reports it)")
    net.add_argument("--replica_id", type=str, default=None)
    scope = ap.add_argument_group("telemetry")
    scope.add_argument("--flight_dir", type=str, default="flight_bundles",
                       help="flight-recorder bundle dir ('off' disables); a "
                            "replica_id subdir keeps fleet postmortems apart")
    scope.add_argument("--telemetry_dir", type=str, default=None,
                       help="per-process telemetry dir (a replica_id subdir), "
                            "rewritten atomically every --telemetry_interval_s")
    scope.add_argument("--telemetry_interval_s", type=float, default=0.2)
    add_profiler_args(ap)
    return ap


def warmup(replica, text_seq_len: int) -> None:
    """One self-request through the submit → stream → done path."""
    import numpy as np
    stream = replica.submit(np.zeros((text_seq_len,), np.int32), seed=0, max_tokens=1)
    for kind, _payload in stream.events(timeout=300.0,
                                        still_alive=lambda: replica.healthy):
        if kind != "row":
            break


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    install_sigusr2_profiler("profile_artifacts", args)

    from .. import obs
    from ..chaos import faults
    from ..degrade import WedgeWatchdog
    from ..device import resolve_device
    from ..fleet import ReplicaServer
    from ..gateway import Replica
    from ..serve import PriorityDeadlinePolicy

    device = resolve_device(args.device)
    obs.configure()
    counter = obs.install_compile_counter()
    rid = args.replica_id or f"replica-{os.getpid()}"
    if args.flight_dir != "off":
        obs.configure_recorder(os.path.join(args.flight_dir, rid), sample_interval_s=1.0)
        obs.install_signal_dump()
    exporter = None
    if args.telemetry_dir:
        exporter = obs.TelemetryExporter(os.path.join(args.telemetry_dir, rid),
                                         interval_s=args.telemetry_interval_s, proc=rid)
    # a parent-scripted fault plan keyed on the engine's decode-step counter
    # (serve/engine.py calls chaos.step_hook before every step dispatch);
    # no-op without the environment variable
    faults.install_from_env()

    engine = build_wrapper(args, device).serve_engine(
        slots=args.slots, precision=args.precision, steps_per_sync=args.steps_per_sync,
        decode_health=args.decode_health, prefill_chunk=args.prefill_chunk,
        kv_block_tokens=args.kv_block_tokens, kv_pool_blocks=args.kv_pool_blocks,
        radix_cache=args.radix_cache)
    replica = Replica(engine, replica_id=rid, maxsize=args.queue_maxsize,
                      policy=(PriorityDeadlinePolicy()
                              if args.policy == "priority_deadline" else None)).start()
    if args.warmup:
        warmup(replica, engine.text_seq_len)
    watchdog = None
    if args.wedge_timeout_s > 0:
        # progress = the loop's monotonic dispatch counter, busy = accepted
        # work not yet completed; a trip latches Replica.mark_wedged, so the
        # health verb carries reason "wedged" and the controller drains us
        def _on_wedge(detail):
            replica.mark_wedged(detail)
            obs.dump_recorder("wedged", force=True)

        watchdog = WedgeWatchdog(lambda: (replica.progress or 0, replica.inflight > 0),
                                 args.wedge_timeout_s, on_wedge=_on_wedge).start()
    server = ReplicaServer(replica, host=args.host, port=args.port,
                           compile_counter=counter).start()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    print(json.dumps({
        "fleet_replica": 1, "addr": server.addr, "pid": os.getpid(),
        "replica_id": rid, "slots": args.slots,
        "aot_loaded": replica.aot_loaded, "aot_refusal": None,
        "warmed": bool(args.warmup),
        "backend_compiles": counter.count}), flush=True)

    stop.wait()
    # graceful preemption: stop accepting, finish accepted work, exit 0
    if watchdog is not None:
        watchdog.stop()
    server.shutdown()
    replica.drain(timeout=60)
    if exporter is not None:
        exporter.close()
    obs.disable_recorder()
    return 0


if __name__ == "__main__":
    sys.exit(main())
