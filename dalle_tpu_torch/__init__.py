"""dalle_tpu_torch: the PyTorch/CUDA port of dalle_tpu for NVIDIA Hopper.

Text token ids → image tokens → pixels: ``DALLE`` generates image tokens
with a KV cache whose decode attention is a hand-written CUDA kernel
(``ops/decode_attention.py``, ``csrc/decode_attention.cu``), and
``DalleWithVae.generate_images`` decodes them to pixels through the dVAE.
Training: ``DalleTrainer.train_step`` takes text ids and image token ids to
a clipped Adam update, its attention forward and backward in hand-written
CUDA kernels (``ops/fused_attention.py``, ``csrc/fused_attention.cu``), or
with ``use_pallas="persist"`` the whole-sequence kernels
(``ops/persistent_attention.py``, ``csrc/persistent_attention.cu``).
Serving: ``DalleWithVae.serve_engine`` builds the continuous-batching
``serve.DecodeEngine``, whose windowed attention over a dense or paged cache
runs in hand-written CUDA kernels (``csrc/decode_window_attention.cu``); by
default over int8 weights (``ops/quantize_weights.py``), whose products at
decode sizes run in a hand-written kernel (``csrc/int8w_linear.cu``).
``DALLE.generate_images_tokens_speculative`` is the draft-and-verify
sampler, ``DALLE.generate_texts_tokens`` completes captions, and
``shift_tokens`` models run token shift in training and cached decode.
Sequence-parallel training (``TrainConfig(mesh=MeshConfig(sp=P))``) runs
every attention layer as ring attention over P ranks
(``parallel/ring_attention.py``), each chunk pair through the chunk kernels
(``ops/chunk_attention.py``, ``csrc/chunk_attention.cu``).
From the command line, ``python -m dalle_tpu_torch.cli.train_dalle`` trains
on (caption, image) pairs: captions through the CLIP BPE tokenizer
(``text/``, a native merge core built with g++ at first use), images through
the dVAE's encoder, checkpoints with the model's identity inside
(``train/checkpoints.py``); ``python -m dalle_tpu_torch.cli.generate``
rebuilds the model from such a checkpoint and writes PNGs, reranked by a
CLIP with ``--clip_path``. ``python -m dalle_tpu_torch.cli.train_vae``
trains the dVAE (``VAETrainer``) and ``python -m
dalle_tpu_torch.cli.train_clip`` the CLIP (``CLIPTrainer``); the three
trainers share one shell with NaN rollback (``train/base_trainer.py``).
The taming stack: ``python -m dalle_tpu_torch.cli.train_vqgan`` trains a
VQGAN (``models/vqgan.py``) with its PatchGAN discriminator and LPIPS on the
shipped perceptual weights (``VQGANTrainer``); ``models/pretrained.py``
loads a taming checkpoint with its yaml, or OpenAI's dVAE pickles, from
local files as the VAE of ``train_dalle`` and ``generate``
(``--vqgan_model_path``, ``--vqgan_config_path``, ``--openai_vae_dir``);
``models/mingpt.py`` and ``models/cond_transformer.py`` are taming's second
stage, whose sampling decodes through the decode kernel. ``reversible=True``
trains DALL·E with reversible blocks (``models/reversible.py``), the fused
attention kernels running again inside the backward's recompute.
The trainers' telemetry (``TrainConfig(obs=ObsConfig(...))``: spans, the
step breakdown, device gauges, the stall watchdog, the health taps and
their sentries, ``profile_step``) is the JAX package's, in ``obs/`` and
``train/``; ``python -m dalle_tpu_torch.cli.obs_report`` summarises a run.
The serving plane is the JAX package's too: ``python -m
dalle_tpu_torch.cli.serve_gateway`` serves ``/v1/generate`` (blocking or
SSE rows) and ``/v1/images`` over HTTP from in-process replicas of the
engine (``gateway/``: admission, routing with mid-stream failover, the SLO
sentry), and ``python -m dalle_tpu_torch.cli.serve_replica`` serves one
engine over the fleet's frame protocol, which ``fleet/`` spawns, routes,
scales and heals (``FleetManager``, ``RemoteReplica``,
``FleetController``).
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
Importing the package builds nothing; kernels are compiled at first use.
"""

from .config import (AnnealConfig, ClipConfig, DalleConfig, DVAEConfig, MeshConfig,
                     ObsConfig, OptimConfig, PrecisionConfig, TrainConfig, TransformerConfig,
                     VQGANConfig, dalle_1p4b)
from .convert import adam_state_from_optax, clip_state_dict, dalle_state_dict, dvae_state_dict
from .device import resolve_device
from .models.clip import CLIP, init_clip
from .models.dalle import DALLE, init_dalle
from .models.dvae import DiscreteVAE, init_dvae
from .models.cond_transformer import Net2NetTransformer
from .models.mingpt import GPT, GPTConfig, init_gpt
from .models.pretrained import OpenAIDiscreteVAE, VQGanVAE
from .models.vqgan import VQModel, init_vqgan
from .models.wrapper import DalleWithVae, DiscreteVAEAdapter
from .train.checkpoints import load_clip
from .train.trainer_clip import CLIPTrainer
from .train.trainer_dalle import DalleTrainer
from .train.trainer_vae import VAETrainer
from .train.trainer_vqgan import VQGANTrainer

__all__ = ["AnnealConfig", "ClipConfig", "DalleConfig", "DVAEConfig", "MeshConfig",
           "ObsConfig", "OptimConfig", "PrecisionConfig", "TrainConfig", "TransformerConfig", "dalle_1p4b",
           "adam_state_from_optax", "clip_state_dict", "dalle_state_dict", "dvae_state_dict",
           "resolve_device", "CLIP", "init_clip", "load_clip", "DALLE", "init_dalle",
           "DiscreteVAE", "init_dvae", "DalleWithVae", "DiscreteVAEAdapter",
           "CLIPTrainer", "DalleTrainer", "VAETrainer", "VQGANConfig", "VQModel",
           "init_vqgan", "VQGANTrainer", "GPT", "GPTConfig", "init_gpt", "Net2NetTransformer",
           "VQGanVAE", "OpenAIDiscreteVAE"]
