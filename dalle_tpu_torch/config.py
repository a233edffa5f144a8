"""Model and training configuration for the PyTorch port.

A copy of ``DVAEConfig``, ``VQGANConfig``, ``TransformerConfig``,
``DalleConfig``, ``ClipConfig``, ``MeshConfig``, ``PrecisionConfig``, ``OptimConfig``,
``ObsConfig`` and ``AnnealConfig`` from the JAX package (``dalle_tpu/config.py``): same
fields, same defaults, same derived properties, so a config built for one
package builds the same model and optimizer in the other. ``TrainConfig``
carries only the fields the port's trainers read. ``to_dict``/``from_dict``
are the JAX ``ConfigBase``'s: a checkpoint's metadata carries the dicts,
equal to the JAX package's for the same fields, so model identity travels
inside the checkpoint. The JAX package's argparse wiring is not carried
over.
"""

from __future__ import annotations

import math
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Optional, Tuple


def _coerce(tp, value):
    """A JSON value into the annotated field type (lists into tuples,
    nested dicts into their dataclass)."""
    if value is None:
        return None
    origin = getattr(tp, "__origin__", None)
    if origin is tuple:
        args = tp.__args__
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(args[0], v) for v in value)
        return tuple(_coerce(a, v) for a, v in zip(args, value))
    if origin is not None:  # Optional[...] and friends
        args = [a for a in tp.__args__ if a is not type(None)]
        if len(args) == 1:
            return _coerce(args[0], value)
        return value
    if is_dataclass(tp) and isinstance(value, dict):
        return tp.from_dict(value)
    if tp in (int, float, str, bool) and not isinstance(value, tp):
        return tp(value)
    return value


class ConfigBase:
    """dict round trip of a config dataclass (tuples as lists, nested
    configs as dicts); ``from_dict`` ignores keys the class lacks."""

    def to_dict(self) -> dict:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if is_dataclass(v):
                out[f.name] = v.to_dict()
            elif isinstance(v, tuple):
                out[f.name] = list(v)
            else:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict):
        hints = typing.get_type_hints(cls)
        return cls(**{f.name: _coerce(hints[f.name], d[f.name])
                      for f in fields(cls) if f.name in d})


@dataclass(frozen=True)
class DVAEConfig(ConfigBase):
    """Discrete VAE (reference: dalle_pytorch/dalle_pytorch.py:101-252)."""
    image_size: int = 128
    num_tokens: int = 8192       # codebook vocabulary
    codebook_dim: int = 512
    num_layers: int = 3          # conv downsamples; image_seq = (image_size/2**num_layers)**2
    num_resnet_blocks: int = 1
    hidden_dim: int = 64
    channels: int = 3
    smooth_l1_loss: bool = False
    kl_div_loss_weight: float = 0.0
    straight_through: bool = False
    # per-channel (means, stds); reference default is 0.5/0.5 (dalle_pytorch.py:116)
    normalization: Optional[Tuple[Tuple[float, float, float], Tuple[float, float, float]]] = (
        (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    temperature: float = 0.9

    @property
    def image_seq_len(self) -> int:
        return (self.image_size // (2 ** self.num_layers)) ** 2

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2 ** self.num_layers)


@dataclass(frozen=True)
class VQGANConfig(ConfigBase):
    """VQGAN autoencoder (taming's ``VQModel`` / ``GumbelVQ``): the
    defaults are taming's ``vqgan_imagenet_f16_1024``. ``remap_used``
    restricts the interface indices to a used subset of the codebook, its
    unknown codes mapped per ``remap_unknown`` ('random' | 'extra' | an
    int)."""
    embed_dim: int = 256
    n_embed: int = 1024
    double_z: bool = False
    z_channels: int = 256
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0
    quantizer: str = "vq"     # vq | gumbel
    beta: float = 0.25        # commitment cost
    gumbel_kl_weight: float = 5e-4
    straight_through: bool = True
    remap_used: Optional[Tuple[int, ...]] = None
    remap_unknown: str = "random"

    @property
    def num_layers(self) -> int:
        return int(math.log2(self.resolution) - math.log2(self.attn_resolutions[0]))


@dataclass(frozen=True)
class TransformerConfig(ConfigBase):
    """Transformer stack (reference: dalle_pytorch/transformer.py:204-328)."""
    seq_len: int = 512           # total text+image sequence length (no bos slot)
    causal: bool = True
    dim: int = 512
    depth: int = 12
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    # cyclic per-layer attention kinds: full | axial_row | axial_col | conv_like | sparse
    attn_types: Tuple[str, ...] = ("full",)
    image_fmap_size: int = 32
    sparse_attn_kernel: int = 5          # conv_like unfold kernel
    sparse_block_size: int = 128         # block-sparse tile
    sparse_num_random_blocks: int = 0    # 0 → seq_len // block // 4 like the reference
    # base seed for 'sparse' random-block patterns; layer i uses seed + i
    sparse_mask_seed: int = 0
    reversible: bool = False
    use_remat: bool = True
    stable: bool = False                 # stable softmax + DivideMax
    sandwich_norm: bool = False
    shift_tokens: bool = False
    rotary_emb: bool = True
    shared_attn_ids: Optional[Tuple[int, ...]] = None
    shared_ff_ids: Optional[Tuple[int, ...]] = None
    optimize_for_inference: bool = False
    # full-sequence attention: "auto" (on the card the fused kernel K1 below
    # 2048 tokens and the flash kernel K4 from there on; dense on the CPU),
    # "fused" (K1), "flash"/"on" (K4), "off" (dense); see
    # ops/flash_attention.resolve_use_pallas
    use_pallas: str = "auto"
    # False keeps the attention scores in the activation dtype
    attn_softmax_f32: bool = True


@dataclass(frozen=True)
class DalleConfig(ConfigBase):
    """DALL·E AR model (reference: dalle_pytorch/dalle_pytorch.py:336-440)."""
    num_text_tokens: int = 10000
    text_seq_len: int = 256
    dim: int = 512
    depth: int = 12
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    attn_types: Tuple[str, ...] = ("full",)
    loss_img_weight: float = 7.0
    loss_chunk: int = 0
    stable: bool = False
    sandwich_norm: bool = False
    shift_tokens: bool = False
    rotary_emb: bool = True
    shared_attn_ids: Optional[Tuple[int, ...]] = None
    shared_ff_ids: Optional[Tuple[int, ...]] = None
    share_input_output_emb: bool = False
    reversible: bool = False
    use_remat: bool = True
    use_pallas: str = "auto"
    attn_softmax_f32: bool = True
    sparse_block_size: int = 128
    sparse_attn_kernel: int = 5
    sparse_mask_seed: int = 0   # per-layer patterns: seed + layer_index
    # filled from the vae at model build time
    image_size: int = 128
    image_vocab_size: int = 8192   # vae num_tokens
    image_fmap_size: int = 16      # image_size / 2**vae_layers

    @property
    def image_seq_len(self) -> int:
        return self.image_fmap_size ** 2

    @property
    def total_seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def total_tokens(self) -> int:
        # text vocab reserves one unique pad token per text position (ref :370)
        return self.num_text_tokens + self.text_seq_len + self.image_vocab_size

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            seq_len=self.total_seq_len, causal=True,
            dim=self.dim, depth=self.depth, heads=self.heads, dim_head=self.dim_head,
            ff_mult=self.ff_mult, attn_dropout=self.attn_dropout, ff_dropout=self.ff_dropout,
            attn_types=self.attn_types, image_fmap_size=self.image_fmap_size,
            reversible=self.reversible, use_remat=self.use_remat, stable=self.stable,
            sandwich_norm=self.sandwich_norm, shift_tokens=self.shift_tokens,
            rotary_emb=self.rotary_emb, shared_attn_ids=self.shared_attn_ids,
            shared_ff_ids=self.shared_ff_ids, use_pallas=self.use_pallas,
            attn_softmax_f32=self.attn_softmax_f32,
            sparse_block_size=self.sparse_block_size, sparse_attn_kernel=self.sparse_attn_kernel,
            sparse_mask_seed=self.sparse_mask_seed,
        )


@dataclass(frozen=True)
class ClipConfig(ConfigBase):
    """CLIP reranker (reference: dalle_pytorch/dalle_pytorch.py:256-332)."""
    dim_text: int = 512
    dim_image: int = 512
    dim_latent: int = 512
    num_text_tokens: int = 10000
    text_enc_depth: int = 6
    text_seq_len: int = 256
    text_heads: int = 8
    num_visual_tokens: int = 512
    visual_enc_depth: int = 6
    visual_heads: int = 8
    visual_image_size: int = 256
    visual_patch_size: int = 32
    channels: int = 3


def dalle_1p4b(**overrides) -> DalleConfig:
    """DALL·E-1.4B, the largest configuration the repository supports
    (``bench.py``): 24 layers, 14 heads of 128, dim 1792, the CLIP text
    vocabulary (49,408) over 256 text tokens, 8,192 image tokens on a 16×16
    grid, rotary embeddings, full causal attention. ``overrides`` replace
    fields, e.g. ``depth=2`` for a cut-down run at full width."""
    kw = dict(num_text_tokens=49408, text_seq_len=256, dim=1792, depth=24,
              heads=14, dim_head=128, image_size=128, image_vocab_size=8192,
              image_fmap_size=16, attn_softmax_f32=False, loss_chunk=128,
              use_remat=False)
    kw.update(overrides)
    return DalleConfig(**kw)


# ---------------------------------------------------------------------------
# Mesh / parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig(ConfigBase):
    """Logical device mesh. Axes: dp (data), fsdp (param/opt-state sharding),
    tp (tensor), sp (sequence, for ring attention). The port lays one
    process a rank over it (``parallel/mesh.ProcessMesh``): dp and fsdp
    train across processes, sp across processes (``GroupRing``) or, in one
    process, with its ranks there (``parallel/ring_attention.LocalRing``);
    tp > 1 raises (ROADMAP.md Queue 1 item 11c)."""
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    # names, in mesh order
    axis_names: Tuple[str, ...] = ("dp", "fsdp", "sp", "tp")

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp

    def shape(self) -> Tuple[int, ...]:
        m = {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp, "sp": self.sp}
        return tuple(m[a] for a in self.axis_names)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PrecisionConfig(ConfigBase):
    """Mixed-precision policy: f32 master weights, the forward and backward
    on copies cast to ``compute`` (see ``train/train_state.cast_floating``)."""
    params: str = "float32"
    compute: str = "bfloat16"
    output: str = "float32"


@dataclass(frozen=True)
class OptimConfig(ConfigBase):
    optimizer: str = "adam"
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.5          # ref: legacy/train_dalle.py --clip_grad_norm
    grad_accum_steps: int = 1            # ref: --ga_steps
    lr_decay: bool = False               # ReduceLROnPlateau equivalent (cosine here)
    lr_decay_rate: float = 0.98          # exponential schedule gamma (ref --lr_decay_rate)
    lr_transition_steps: int = 1000      # steps per exponential decay application
    warmup_steps: int = 0
    total_steps: int = 100_000
    lr_scheduler: str = "constant"       # constant | cosine | exponential | plateau
    # plateau (ReduceLROnPlateau parity): factor 0.5, patience 10, cooldown
    # 10, min lr as a fraction of the base lr
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    plateau_cooldown: int = 10
    plateau_min_scale: float = 1e-3


SNAPSHOT_MODES = ("auto", "device", "host")


@dataclass(frozen=True)
class ObsConfig(ConfigBase):
    """The training loop's telemetry (``obs/``), the JAX package's fields and
    defaults. The step breakdown is always computed (host ``perf_counter``
    arithmetic); spans, the watchdog, the Prometheus textfile and the health
    taps each need their switch."""
    trace: bool = False            # collect spans into the ring
    trace_dir: str = ""            # export dir ("" → <checkpoint_dir>/obs)
    ring_capacity: int = 65536     # spans kept; overflow is counted
    # no completed step within this many seconds → a stall report (open
    # spans, thread stacks); 0 disables
    watchdog_deadline_s: float = 0.0
    watchdog_dump_stacks: bool = True
    # poll the memory and compile gauges every N steps (at metrics
    # boundaries); 0 disables
    device_poll_every: int = 10
    prometheus_path: str = ""      # node-exporter textfile ("" = off)
    # per-layer-group grad/param/update/non-finite taps (and the codebook
    # vitals of the VAE trainers), read with the step's other metrics
    health: bool = False
    # path depth of a layer group, "params" levels dropped: 1 = the model's
    # subtrees (transformer, encoder, decoder, ...)
    health_group_depth: int = 1
    # the anomaly sentry's thresholds (obs/anomaly.py) and its warm-up
    health_loss_z: float = 6.0
    health_grad_factor: float = 10.0
    health_perplexity_floor: float = 4.0
    health_min_samples: int = 5


@dataclass(frozen=True)
class TrainConfig(ConfigBase):
    """The fields of the JAX package's ``TrainConfig`` that the port's
    trainers read (``train/base_trainer.py``): checkpoints, NaN rollback, the
    runtime lr scale, the host overlap of the training loop (scanned
    steps, the metrics cadence, deferred metrics, device prefetch),
    ``profile_step``, the telemetry (``obs``), ``epochs``, ``resume``,
    asynchronous checkpoint writes (``async_checkpointing``) and
    ``log_artifacts``, with the JAX defaults. ``log_artifacts=True``
    uploads to wandb in the JAX package; the port's trainers refuse it
    (``ROADMAP.md`` Queue 1 item 12).

    One default differs: ``checkpoint_dir`` is None, and then the trainer
    keeps no checkpoints (the JAX package writes to ``./checkpoints``).
    Nothing is written unless the caller names a directory."""
    batch_size: int = 64                 # global batch
    epochs: int = 20
    seed: int = 42
    log_every: int = 10
    save_every_steps: int = 1000
    keep_n_checkpoints: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    # a save blocks only for the copy of the state to the host; the write
    # runs on a thread, drained at restore, at a SIGUSR1/SIGTERM save, at
    # fit's end and at close
    async_checkpointing: bool = True
    preflight_checkpoint: bool = True    # save before the first step
    # on a non-finite loss, put back the masters and the optimizer state of
    # the last save (or of fit's start)
    nan_rollback: bool = True
    # where that snapshot lives: "device" (a copy on the card), "host", or
    # "auto" (the card when its free memory holds 1.15× the snapshot); the
    # entry points' --rollback_snapshot
    rollback_snapshot: str = "auto"
    sample_every_steps: int = 0          # fit's sample_fn every N steps
    # read the step's metrics on the host (one sync) every N steps; the
    # other steps return {} and fit skips their NaN check and log
    metrics_every: int = 1
    # runtime learning-rate multiplier (JAX: a TrainState data leaf), a
    # device scalar at 1.0 that set_lr_scale moves
    runtime_lr_scale: bool = False
    # batches kept on the card ahead of the step loop (0: none)
    device_prefetch: int = 2
    # read the metrics one boundary late (the record carries metrics_step)
    defer_metrics: bool = False
    # k optimizer steps per train_steps call from k stacked batches
    scan_steps: int = 1
    # > 0: profile the step that contains this step with torch.profiler
    # into <checkpoint_dir>/profile_step<N>
    profile_step: int = 0
    # upload each checkpoint as a wandb artifact (refused by the port)
    log_artifacts: bool = False
    optim: OptimConfig = field(default_factory=OptimConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    def __post_init__(self):
        if self.rollback_snapshot not in SNAPSHOT_MODES:
            raise ValueError(f"rollback_snapshot must be one of {SNAPSHOT_MODES}, "
                             f"got {self.rollback_snapshot!r}")


# temperature annealing for dVAE training (ref: legacy/train_vae.py:269-271)
@dataclass(frozen=True)
class AnnealConfig(ConfigBase):
    starting_temp: float = 1.0
    temp_min: float = 0.5
    anneal_rate: float = 1e-6
