"""Chaos smoke: scripted fault scenarios over a real two-process gloo pod,
each holding the recovery invariant. The counterpart of
``scripts/chaos_smoke.py``.

**Bit-exact resume**: the state after recovery (masters and optimizer,
``chaos_worker.state_digest``) is bit for bit that of an uninterrupted run
at the same step.

Scenarios (the fast set; ``--heavy`` adds ``hang_detect``):

* ``kill_respawn``: SIGKILL worker 1 mid-step; the elastic agent tears the
  epoch down and respawns the gang, which restores the last durable step
  and resumes; the digests equal the clean two-process reference.
* ``kill_sigterm``: SIGTERM every worker instead: each finishes its step in
  flight, takes a drained save and exits asking for reconfiguration; the
  step it was stopped at is a durable checkpoint.
* ``coordinator_flaky``: worker 1's first two dials of the coordinator fail
  (injected); the retry layer absorbs them, with no reconfiguration.
* ``ckpt_io_flaky``: the same for the checkpoint writes.
* ``corrupt_recover``: corrupt the newest durable checkpoint, then SIGKILL:
  recovery falls back to the previous durable step, quarantines the
  corrupt one, and still meets the reference digest.
* ``shrink``: SIGKILL under ``policy="shrink"``: the pod reshapes to world
  size 1, restores the world-2 checkpoint and resumes; the oracle is a
  clean one-process run pinned to the same restore step (changing the
  world changes the order of the gradient sums).
* ``hang_detect`` (``--heavy``): worker 1 hangs mid-step; the survivor's
  peer watcher and the agent's heartbeat timeout catch it.

Verdicts, the agent's events and the workers' logs land in ``--outdir``.
The workers' model and device are ``--worker_args`` (``chaos_worker``'s
flags; default the small dVAE on the card).

Run: ``python -m dalle_tpu_torch.cli.chaos_smoke --outdir OUT --worker_args
"--device cpu" [--scenarios kill_respawn]``
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shlex
import shutil
import subprocess
import sys
import time

from ..chaos import EPOCH_ENV, PLAN_ENV, RANK_ENV, Fault, FaultPlan
from ..obs import configure as obs_configure
from ..obs import configure_recorder, dump_recorder, metrics_snapshot
from ..parallel.elastic import DIR_ENV, WORKER_ENV, ElasticAgent, python_worker_env

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = [sys.executable, "-m", "dalle_tpu_torch.cli.chaos_worker"]
FAST = ("kill_respawn", "kill_sigterm", "coordinator_flaky", "ckpt_io_flaky",
        "corrupt_recover", "shrink")

FAILURES: list = []


def check(ok: bool, what: str) -> bool:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)
    return ok


def child_env(extra=None):
    return python_worker_env(repo_root=ROOT, extra=extra)


def make_spawn(run_dir: str, target: int, save_every: int, plan=None,
               peer_timeout_s: float = 0.0, extra_args=()):
    """The agent's spawn: one ``chaos_worker`` child per member, its log in
    ``<run_dir>/logs/``."""
    logdir = os.path.join(run_dir, "logs")
    os.makedirs(logdir, exist_ok=True)

    def spawn(worker_id, epoch):
        extra = {DIR_ENV: run_dir, WORKER_ENV: str(worker_id)}
        if plan is not None:
            extra.update({PLAN_ENV: plan.to_json(), RANK_ENV: str(worker_id),
                          EPOCH_ENV: str(epoch.epoch)})
        cmd = WORKER + ["--run_dir", run_dir, "--target_steps", str(target),
                        "--save_every", str(save_every), *extra_args]
        if peer_timeout_s > 0:
            cmd += ["--peer_timeout_s", str(peer_timeout_s)]
        log = open(os.path.join(logdir, f"w{worker_id}_e{epoch.epoch}.log"), "a")
        return subprocess.Popen(cmd, env=child_env(extra), stdout=log,
                                stderr=subprocess.STDOUT, cwd=ROOT)
    return spawn


def read_digests(run_dir: str) -> dict:
    out = {}
    for p in glob.glob(os.path.join(run_dir, "digest_*.json")):
        with open(p, encoding="utf-8") as fh:
            out[os.path.basename(p)[len("digest_"):-len(".json")]] = json.load(fh)
    return out


def counters_of(digests: dict) -> dict:
    merged: dict = {}
    for doc in digests.values():
        for k, v in doc.get("counters", {}).items():
            merged[k] = merged.get(k, 0) + v
    return merged


def tail_logs(run_dir: str, n: int = 30) -> str:
    out = []
    for p in sorted(glob.glob(os.path.join(run_dir, "logs", "*.log"))):
        with open(p, errors="replace") as fh:
            out.append(f"---- {os.path.basename(p)} ----\n" + "".join(fh.readlines()[-n:]))
    return "\n".join(out)


def run_pod(name: str, outdir: str, *, nproc: int, target: int, save_every: int,
            plan=None, policy: str = "respawn", hb_timeout_s: float = 0.0,
            peer_timeout_s: float = 0.0, term_grace_s: float = 5.0,
            deadline_s: float = 420.0, extra_args=()):
    """One pod under the elastic agent → (agent, digests)."""
    run_dir = os.path.join(outdir, name)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    agent = ElasticAgent(run_dir, make_spawn(run_dir, target, save_every, plan,
                                             peer_timeout_s, extra_args),
                         members=list(range(nproc)), policy=policy,
                         hb_timeout_s=hb_timeout_s, term_grace_s=term_grace_s, poll_s=0.2)
    t0 = time.time()
    try:
        agent.run(deadline_s=deadline_s)
    except Exception as exc:  # noqa: BLE001 - a failed pod gives a verdict and
        # its logs, not a stack trace that hides them
        check(False, f"{name}: pod run failed: {exc!r}")
        print(tail_logs(run_dir))
    digests = read_digests(run_dir)
    print(f"-- {name}: {time.time() - t0:.1f}s, {agent.reconfigures} reconfigure(s), "
          f"{len(digests)} digest(s)", flush=True)
    return agent, digests


def pinned_reference(outdir: str, name: str, target: int, restored_from: int,
                     extra_args=()):
    """The digest of a clean one-process run restored from ``name``'s
    checkpoint at ``restored_from`` (a copy), or None."""
    ref_dir = os.path.join(outdir, name + "_ref")
    shutil.rmtree(ref_dir, ignore_errors=True)
    shutil.copytree(os.path.join(outdir, name, "ckpt"), os.path.join(ref_dir, "ckpt"))
    with open(os.path.join(ref_dir, "ref.log"), "w") as log:
        rc = subprocess.run(WORKER + ["--run_dir", ref_dir, "--target_steps", str(target),
                                      "--save_every", "0", "--restore_step",
                                      str(restored_from), "--reference", *extra_args],
                            env=child_env(), stdout=log, stderr=subprocess.STDOUT,
                            cwd=ROOT).returncode
    refs = read_digests(ref_dir)
    return next(iter(refs.values()))["digest"] if rc == 0 and refs else None


def verdict(outdir: str, name: str, agent, digests: dict, checks: dict) -> dict:
    doc = {"scenario": name, "ok": all(checks.values()), "checks": checks,
           "events": agent.events if agent is not None else [], "digests": digests}
    path = os.path.join(outdir, name, "verdict.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, default=str)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default="./chaos_smoke_out")
    ap.add_argument("--target_steps", type=int, default=8)
    ap.add_argument("--save_every", type=int, default=2)
    ap.add_argument("--kill_step", type=int, default=5)
    ap.add_argument("--heavy", action="store_true",
                    help="add hang_detect (its liveness timeouts dominate its time)")
    ap.add_argument("--scenarios", default="",
                    help=f"comma-separated subset of {FAST + ('hang_detect',)} "
                         "(default: the fast set)")
    ap.add_argument("--worker_args", default="",
                    help="chaos_worker flags for every worker (its model, device, dtype)")
    ap.add_argument("--deadline_s", type=float, default=420.0)
    args = ap.parse_args(argv)
    outdir = os.path.abspath(args.outdir)
    os.makedirs(outdir, exist_ok=True)
    obs_configure()
    configure_recorder(os.path.join(outdir, "flight"), min_dump_interval_s=0.0)
    target, save_every, kill_at = args.target_steps, args.save_every, args.kill_step
    wargs = tuple(shlex.split(args.worker_args))
    wanted = set(filter(None, args.scenarios.split(","))) or set(FAST)
    if args.heavy:
        wanted.add("hang_detect")
    FAILURES.clear()
    t_all = time.time()
    summaries = []
    pod = dict(target=target, save_every=save_every, deadline_s=args.deadline_s,
               extra_args=wargs)

    # -- reference: an uninterrupted two-process run, the bitwise oracle --------
    agent, ref = run_pod("reference2", outdir, nproc=2, **dict(pod, save_every=0))
    ref_digest = next(iter(ref.values()))["digest"] if ref else None
    ok = check(len(ref) == 2 and len({d["digest"] for d in ref.values()}) == 1,
               "reference2: both workers agree on the state digest")
    if not ok:
        print(tail_logs(os.path.join(outdir, "reference2")))
    summaries.append(verdict(outdir, "reference2", agent, ref, {"agree": ok}))

    def assert_recovered(name, agent, digests, *, expect_reconfigure=True,
                         restored_below=None):
        checks = {}
        limit = kill_at if restored_below is None else restored_below
        checks["bitwise_resume"] = check(
            bool(digests) and {d["digest"] for d in digests.values()} == {ref_digest},
            f"{name}: the state after recovery is bit for bit the uninterrupted "
            f"reference's at step {target}")
        if expect_reconfigure:
            kinds = [e["kind"] for e in agent.events]
            checks["reconfigured"] = check("reconfigure" in kinds,
                                           f"{name}: the agent reshaped the pod ({kinds})")
            checks["resumed_durable"] = check(
                all(d.get("restored_from") is not None and 0 < d["restored_from"] < limit
                    or d.get("epoch", 0) == 0 for d in digests.values())
                and any(d.get("restored_from") is not None for d in digests.values()),
                f"{name}: recovery resumed from a durable step < {limit}")
        checks["world_size"] = check(all(d["world_size"] == 2 for d in digests.values()),
                                     f"{name}: completed at world size 2")
        if not all(checks.values()):
            print(tail_logs(os.path.join(outdir, name)))
        return checks

    if "kill_respawn" in wanted:
        plan = FaultPlan([Fault(kind="kill", step=kill_at, rank=1, signal="SIGKILL")])
        agent, digests = run_pod("kill_respawn", outdir, nproc=2, plan=plan, **pod)
        checks = assert_recovered("kill_respawn", agent, digests)
        checks["worker_lost"] = check(
            any(e["kind"] == "worker_lost" and e.get("worker") == 1 for e in agent.events),
            "kill_respawn: the agent saw worker 1 die")
        summaries.append(verdict(outdir, "kill_respawn", agent, digests, checks))
        dump_recorder("kill_respawn")

    if "kill_sigterm" in wanted:
        # every worker at once, as a real preemption
        plan = FaultPlan([Fault(kind="kill", step=kill_at, rank=-1, signal="SIGTERM")])
        agent, digests = run_pod("kill_sigterm", outdir, nproc=2, plan=plan, **pod)
        # the latch lands while step kill_at + 1 is in flight: the save is there
        boundary = kill_at + 1
        checks = assert_recovered("kill_sigterm", agent, digests,
                                  restored_below=boundary + 1)
        checks["graceful_save"] = check(
            os.path.isdir(os.path.join(outdir, "kill_sigterm", "ckpt", str(boundary))),
            f"kill_sigterm: the stopped workers left a durable checkpoint at {boundary}")
        summaries.append(verdict(outdir, "kill_sigterm", agent, digests, checks))

    for name, site, rank in (("coordinator_flaky", "coordinator_connect", 1),
                             ("ckpt_io_flaky", "ckpt_save", 0)):
        if name not in wanted:
            continue
        plan = FaultPlan([Fault(kind="fail_io", site=site, rank=rank, times=2)])
        agent, digests = run_pod(name, outdir, nproc=2, plan=plan, **pod)
        checks = assert_recovered(name, agent, digests, expect_reconfigure=False)
        cs = counters_of(digests)
        checks["absorbed"] = check(
            agent.reconfigures == 0
            and cs.get(f'retry.attempts_total{{op="{site}"}}', 0) >= 2
            and cs.get(f'retry.recovered_total{{op="{site}"}}', 0) >= 1,
            f"{name}: the injected {site} failures were absorbed by the retry layer "
            f"({ {k: v for k, v in cs.items() if 'retry' in k} })")
        summaries.append(verdict(outdir, name, agent, digests, checks))

    if "corrupt_recover" in wanted:
        ckpt_dir = os.path.join(outdir, "corrupt_recover", "ckpt")
        plan = FaultPlan([Fault(kind="corrupt_ckpt", step=kill_at, rank=1, path=ckpt_dir,
                                mode="garbage"),
                          Fault(kind="kill", step=kill_at, rank=1, signal="SIGKILL")])
        # synchronous saves: the scenario scripts against "the newest durable
        # step is the save before kill_at"
        agent, digests = run_pod("corrupt_recover", outdir, nproc=2, plan=plan,
                                 **dict(pod, extra_args=wargs + ("--sync_ckpt",)))
        checks = assert_recovered("corrupt_recover", agent, digests)
        corrupted = kill_at - 1
        checks["fallback"] = check(
            bool(glob.glob(os.path.join(ckpt_dir, "*.corrupt")))
            and all(d.get("restored_from") is not None and d["restored_from"] < corrupted
                    for d in digests.values()),
            f"corrupt_recover: the restore fell back past the corrupted step {corrupted} "
            "(quarantined) to an older durable one")
        summaries.append(verdict(outdir, "corrupt_recover", agent, digests, checks))
        dump_recorder("corrupt_recover")

    if "shrink" in wanted:
        plan = FaultPlan([Fault(kind="kill", step=kill_at, rank=1, signal="SIGKILL")])
        agent, digests = run_pod("shrink", outdir, nproc=2, plan=plan, policy="shrink",
                                 **pod)
        w0 = digests.get("w0", {})
        restored_from = w0.get("restored_from")
        ref_d = (pinned_reference(outdir, "shrink", target, restored_from, wargs)
                 if restored_from is not None else None)
        checks = {
            "shrunk": check(w0.get("world_size") == 1 and agent.reconfigures >= 1,
                            "shrink: the pod reshaped to world size 1 and completed"),
            "reshard_resume": check(
                restored_from is not None and 0 < restored_from < kill_at,
                f"shrink: the survivor restored a world-2 checkpoint (step "
                f"{restored_from}) at world 1"),
            "bitwise_vs_pinned_ref": check(
                ref_d is not None and w0.get("digest") == ref_d,
                "shrink: the recovered state is bit for bit a clean one-process run "
                "pinned to the same restore step"),
        }
        if not all(checks.values()):
            print(tail_logs(os.path.join(outdir, "shrink")))
        summaries.append(verdict(outdir, "shrink", agent, digests, checks))

    if "hang_detect" in wanted:
        plan = FaultPlan([Fault(kind="hang", step=kill_at, rank=1, duration_s=600.0)])
        agent, digests = run_pod("hang_detect", outdir, nproc=2, plan=plan,
                                 hb_timeout_s=3.0, peer_timeout_s=3.0, term_grace_s=3.0,
                                 **pod)
        checks = assert_recovered("hang_detect", agent, digests)
        checks["hang_seen"] = check(
            any(e["kind"] in ("worker_hung", "worker_lost") for e in agent.events),
            "hang_detect: liveness, not an exit code, caught the hang")
        summaries.append(verdict(outdir, "hang_detect", agent, digests, checks))

    with open(os.path.join(outdir, "metrics.jsonl"), "w", encoding="utf-8") as fh:
        fh.write(json.dumps({"step": 0, **metrics_snapshot()}) + "\n")
    summary = {"ok": not FAILURES, "failures": list(FAILURES),
               "elapsed_s": round(time.time() - t_all, 1),
               "scenarios": {s["scenario"]: s["ok"] for s in summaries}}
    with open(os.path.join(outdir, "summary.json"), "w", encoding="utf-8") as fh:
        json.dump(summary, fh, indent=2)
    print(f"\nchaos_smoke: {'GREEN' if not FAILURES else 'FAILED'} ({len(summaries)} "
          f"scenarios, {summary['elapsed_s']}s)"
          + (f"\n  failures: {FAILURES}" if FAILURES else ""), flush=True)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
