"""What the entry points share: the VAE sidecar, the VAE flags, the
training flags that every trainer takes (``add_overlap_args``,
``add_telemetry_args``), the signal handlers (``install_resilience``:
SIGTERM's graceful preemption and SIGUSR1's checkpoint; the on-demand
profiler on SIGUSR2), uploading a batch of images, and writing PNGs.

Port of ``scripts/_common.py``. The VAE precedence chain is the
reference's: the VAE embedded in a checkpoint directory (``vae/``), then
``--vae_path`` (a port dVAE checkpoint), then the taming VQGAN
(``--taming`` / ``--vqgan_model_path`` with ``--vqgan_config_path``), then
``--untrained_vae`` (random weights from seed 0), then OpenAI's dVAE
(``--openai_vae_dir``). The pretrained VAEs load local files only
(``models/pretrained.py``); without them the chain raises where the JAX
package downloads.

PNGs are written by the port's codec (``data/image_codec.py``): the card's
machine has no PIL.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import SNAPSHOT_MODES, DVAEConfig, ObsConfig
from ..data.image_codec import write_png
from ..device import to_device
from ..models.dvae import init_dvae
from ..models.wrapper import DiscreteVAEAdapter
from ..train.checkpoints import CheckpointManager, load_model_checkpoint


def unported(flag: str, item: str) -> NotImplementedError:
    """The error for a flag whose code is not ported yet."""
    return NotImplementedError(f"{flag} is not ported yet (ROADMAP.md Queue 1 item {item})")


def save_vae_sidecar(output_dir: str, vae) -> bool:
    """Embed the frozen dVAE (weights and hparams) in ``<output_dir>/vae``,
    so generation needs only ``--dalle_path``. Only a ``DiscreteVAEAdapter``
    is embedded, and only once: a resumed run keeps the VAE its model was
    trained with. Returns True when written."""
    if type(vae) is not DiscreteVAEAdapter:
        return False
    mgr = CheckpointManager(os.path.join(output_dir, "vae"))
    if mgr.latest_step() is not None:
        return False
    mgr.save(0, {"model": vae.model.state_dict()},
             {"vae_class_name": type(vae).__name__,
              "hparams": vae.model.cfg.to_dict()})
    return True


def load_vae_sidecar(ckpt_dir: str, device) -> Optional[DiscreteVAEAdapter]:
    """The VAE ``save_vae_sidecar`` embedded in ``ckpt_dir``; None if absent."""
    mgr = CheckpointManager(os.path.join(ckpt_dir, "vae"))
    meta = mgr.load_metadata()
    if meta is None or meta.get("vae_class_name") != "DiscreteVAEAdapter":
        return None
    model = init_dvae(DVAEConfig.from_dict(meta["hparams"]), seed=0, device=device)
    state, _ = mgr.restore(map_location="cpu", mmap=True)
    with torch.no_grad():
        model.load_state_dict(state["model"])
    return DiscreteVAEAdapter(model.eval())


def load_dvae_adapter(ckpt_dir: str, device) -> DiscreteVAEAdapter:
    """A port dVAE checkpoint (``model_class`` "DiscreteVAE") as an adapter."""
    model, _ = load_model_checkpoint(ckpt_dir, "DiscreteVAE", DVAEConfig, init_dvae,
                                     device)
    return DiscreteVAEAdapter(model)


def build_vae_from_args(args, device):
    """The VAE the flags name (after the checkpoint's own, which the entry
    points try first): ``--vae_path``, then the taming VQGAN
    (``--taming`` / ``--vqgan_model_path``), then ``--untrained_vae``, then
    OpenAI's dVAE. The pretrained ones load from local files only
    (``--vqgan_model_path`` with ``--vqgan_config_path``,
    ``--openai_vae_dir``); without them this raises FileNotFoundError
    naming those flags, where the JAX package downloads."""
    from ..models.pretrained import OpenAIDiscreteVAE, VQGanVAE
    if getattr(args, "vae_path", None):
        return load_dvae_adapter(args.vae_path, device)
    if getattr(args, "taming", False) or getattr(args, "vqgan_model_path", None):
        return VQGanVAE.from_pretrained(args.vqgan_model_path,
                                        getattr(args, "vqgan_config_path", None), device)
    if getattr(args, "untrained_vae", False):
        cfg = DVAEConfig(image_size=args.image_size, num_tokens=args.untrained_vae_tokens,
                         codebook_dim=64, num_layers=args.untrained_vae_layers,
                         hidden_dim=32)
        return DiscreteVAEAdapter(init_dvae(cfg, seed=0, device=device))
    return OpenAIDiscreteVAE.from_pretrained(getattr(args, "openai_vae_dir", None), device)


def add_vae_args(parser):
    grp = parser.add_argument_group("vae")
    grp.add_argument("--vae_path", type=str, default=None,
                     help="checkpoint dir of a port dVAE")
    grp.add_argument("--taming", action="store_true",
                     help="the pretrained taming VQGAN (local files only: "
                          "--vqgan_model_path and --vqgan_config_path)")
    grp.add_argument("--vqgan_model_path", type=str, default=None,
                     help="a taming VQGAN checkpoint (.ckpt)")
    grp.add_argument("--vqgan_config_path", type=str, default=None,
                     help="its taming config yaml")
    grp.add_argument("--openai_vae_dir", type=str, default=None,
                     help="a directory with OpenAI's encoder.pkl and decoder.pkl")
    grp.add_argument("--untrained_vae", action="store_true",
                     help="random dVAE (smoke tests; no download needed)")
    grp.add_argument("--untrained_vae_tokens", type=int, default=512)
    grp.add_argument("--untrained_vae_layers", type=int, default=2)
    return parser


def add_overlap_args(parser):
    """The host-overlap flags every trainer's entry point takes, as the JAX
    scripts' ``add_overlap_args``."""
    grp = parser.add_argument_group("host overlap")
    grp.add_argument("--sync_checkpointing", action="store_true",
                     help="write checkpoints on the loop's thread (default: a save "
                          "blocks only for the host snapshot and a thread writes it)")
    grp.add_argument("--device_prefetch", type=int, default=2,
                     help="batches kept on the card ahead of the step loop (0 disables)")
    grp.add_argument("--defer_metrics", action="store_true",
                     help="read the step metrics one boundary late, from a step that "
                          "has finished (a NaN on a step without a save rolls back one "
                          "boundary late)")
    grp.add_argument("--rollback_snapshot", type=str, default="auto",
                     choices=SNAPSHOT_MODES,
                     help="where the NaN-rollback snapshot lives (auto: on the card "
                          "when its free memory holds 1.15x the snapshot, else host)")
    return parser


def overlap_train_kwargs(args) -> dict:
    """``TrainConfig`` keywords from ``add_overlap_args``'s flags and
    ``--scan_steps``."""
    return {"device_prefetch": args.device_prefetch, "defer_metrics": args.defer_metrics,
            "rollback_snapshot": args.rollback_snapshot, "scan_steps": args.scan_steps,
            "async_checkpointing": not args.sync_checkpointing}


def add_telemetry_args(parser):
    """The flags every trainer's entry point takes for its telemetry: the
    JAX scripts' ``add_health_args``, ``--breach_actions`` and
    ``--lr_cut_factor`` (``add_resilience_args``), the telemetry group and
    ``add_profiler_args``, and ``--wandb``, which raises
    (``check_unported_train_args``)."""
    grp = parser.add_argument_group("model health")
    grp.add_argument("--health", action="store_true",
                     help="per-layer-group grad/param/update/non-finite taps (and the "
                          "codebook vitals of the VAE trainers) read with the step's "
                          "metrics, and the anomaly sentries over them")
    grp.add_argument("--health_group_depth", type=int, default=1,
                     help="path depth of a layer group (1 = the model's subtrees)")
    grp.add_argument("--health_loss_z", type=float, default=6.0,
                     help="loss-spike z-score threshold")
    grp.add_argument("--health_grad_factor", type=float, default=10.0,
                     help="grad-norm explosion factor over the EMA")
    grp.add_argument("--health_perplexity_floor", type=float, default=4.0,
                     help="codebook-collapse floor (usage perplexity)")
    grp.add_argument("--health_flight_dir", type=str, default=None,
                     help="flight recorder directory for the breach bundles "
                          "(default with --health: <output_dir>/health_bundles)")
    grp = parser.add_argument_group("resilience")
    grp.add_argument("--no_preemption_handler", action="store_true",
                     help="install no SIGTERM handler (default: SIGTERM finishes the step "
                          "in flight, saves and drains a checkpoint, and exits 0) and no "
                          "SIGUSR1 handler (a drained checkpoint at the next step)")
    grp.add_argument("--breach_actions", action="store_true",
                     help="act on health breaches: nan-precursor → preemptive snapshot, "
                          "grad-explosion → rollback + lr cut, codebook-collapse → lr cut "
                          "+ gumbel re-anneal (pair with --health)")
    grp.add_argument("--lr_cut_factor", type=float, default=0.5,
                     help="lr scale multiplier of an lr-cut action")
    grp = parser.add_argument_group("telemetry")
    grp.add_argument("--trace", action="store_true",
                     help="collect spans; exports <output_dir>/obs/{trace.json,spans.jsonl}")
    grp.add_argument("--watchdog_deadline_s", type=float, default=0.0,
                     help="stall report when no step completes within this many seconds "
                          "(0 = off; the first call builds the kernels, ~1 min)")
    grp.add_argument("--prometheus_path", type=str, default="",
                     help="node-exporter textfile target for the live gauges")
    grp.add_argument("--profiler_dir", type=str, default=None,
                     help="where SIGUSR2 writes a bounded torch.profiler capture "
                          "(default <output_dir>/profile; 'off' disables the handler)")
    grp.add_argument("--profiler_capture_s", type=float, default=5.0,
                     help="seconds a capture lasts")
    grp.add_argument("--wandb", action="store_true",
                     help="not ported (the card's machine has no wandb and no network)")
    return parser


def check_unported_train_args(args):
    if args.wandb:
        raise unported("--wandb (no wandb package and no network on the card's machine)",
                       "12")


def obs_config(args) -> ObsConfig:
    """``ObsConfig`` from ``add_telemetry_args``'s flags."""
    return ObsConfig(trace=args.trace, watchdog_deadline_s=args.watchdog_deadline_s,
                     prometheus_path=args.prometheus_path, health=args.health,
                     health_group_depth=args.health_group_depth,
                     health_loss_z=args.health_loss_z,
                     health_grad_factor=args.health_grad_factor,
                     health_perplexity_floor=args.health_perplexity_floor)


def install_telemetry(args, trainer, output_dir: str, log=print):
    """Arm a built trainer's telemetry per the flags: with ``--health`` a
    flight recorder for the breach bundles (one already configured wins),
    with ``--breach_actions`` the ``BreachActions`` on its sentry. Returns
    the ``MetricsLogger`` writing ``<output_dir>/metrics.jsonl``."""
    from .. import obs
    from ..train.metrics import MetricsLogger
    if args.health and obs.get_recorder() is None:
        obs.configure_recorder(args.health_flight_dir
                               or os.path.join(output_dir, "health_bundles"))
    if args.breach_actions:
        from ..train.actions import BreachActions
        BreachActions(trainer, lr_cut_factor=args.lr_cut_factor, log=log).attach()
        if not args.health:
            log("[actions] --breach_actions without --health: the detectors see no "
                "health/* columns and will never fire")
    os.makedirs(output_dir, exist_ok=True)
    return MetricsLogger(path=os.path.join(output_dir, "metrics.jsonl"))


def install_resilience(args, trainer, log=print):
    """Arm the signal handlers on a built trainer unless
    ``--no_preemption_handler``: SIGTERM's graceful preemption and
    SIGUSR1's checkpoint at the next step boundary."""
    if not args.no_preemption_handler:
        trainer.install_preemption_handler(log=log)
        trainer.install_signal_checkpoint(log=log)


def upload_images(images, device) -> torch.Tensor:
    """A host batch of images as f32 on ``device`` (pinned, without
    blocking the host, on a card), for the VAE's encode there."""
    if isinstance(images, torch.Tensor):
        return images.to(device, torch.float32)
    return to_device(np.asarray(images, np.float32), device)


def install_sigusr2_profiler(default_dir: str, args=None, log=print) -> bool:
    """SIGUSR2 → one bounded ``torch.profiler`` capture into a timestamped
    directory under ``--profiler_dir`` (default ``default_dir``), stopped
    after ``--profiler_capture_s``; a signal during a capture is ignored
    (one capture at a time). The profiler is started and stopped on the
    main thread, where the handler runs: when the capture is due a timer
    thread marks it so and sends SIGUSR2, and that signal stops it. Call
    from the main thread. Returns False when disabled or not installable."""
    import signal
    import threading

    outdir, capture_s = default_dir, 5.0
    if args is not None:
        if getattr(args, "profiler_dir", None) == "off":
            return False
        outdir = getattr(args, "profiler_dir", None) or default_dir
        capture_s = float(getattr(args, "profiler_capture_s", 5.0))
    state = {"prof": None, "stop": False, "path": None}

    def _due():
        state["stop"] = True
        os.kill(os.getpid(), signal.SIGUSR2)

    def _start():
        path = os.path.join(outdir, time.strftime("profile_%Y%m%d_%H%M%S"))
        os.makedirs(path, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        try:
            prof.start()
        except Exception as exc:  # noqa: BLE001 - a profiler that will not start
            # must not kill the loop the signal interrupted
            log(f"[graftscope] profiler start failed: {exc!r}")
            return
        state.update(prof=prof, path=path)
        log(f"[graftscope] SIGUSR2: profiling {capture_s:.1f}s → {path}")
        threading.Timer(capture_s, _due).start()

    def _stop():
        prof, state["prof"], state["stop"] = state["prof"], None, False
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(state["path"], "trace.json"))
        except Exception as exc:  # noqa: BLE001 - the next capture starts afresh
            log(f"[graftscope] profiler stop failed: {exc!r}")

    def _handler(_sig, _frame):
        if state["stop"]:
            _stop()
        elif state["prof"] is None:
            _start()

    try:
        signal.signal(signal.SIGUSR2, _handler)
    except (ValueError, AttributeError):   # not the main thread / no SIGUSR2
        return False
    return True


def add_device_arg(parser):
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs "
                             "the kernels' plain versions)")
    return parser


def to_uint8(images) -> np.ndarray:
    """(b, H, W, C) floats in [0, 1] → uint8, as the JAX package saves them
    (scale by 255, clip, truncate)."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    return (np.asarray(images) * 255).clip(0, 255).astype(np.uint8)


def save_image_grid(images, path: str):
    """(b, H, W, C) images in [0, 1] → one PNG each at ``path.format(i)``."""
    for i, im in enumerate(to_uint8(images)):
        write_png(path.format(i), im)
