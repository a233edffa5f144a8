"""Model configuration for the PyTorch port.

A copy of ``DVAEConfig``, ``TransformerConfig`` and ``DalleConfig`` from the
JAX package (``dalle_tpu/config.py``): same fields, same defaults, same
derived properties, so a config built for one package builds the same model
in the other. The JAX package's CLI/JSON machinery is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DVAEConfig:
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
class TransformerConfig:
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
    # kernel selection of the JAX package's training forward; the port's
    # forward is the dense path whatever this says
    use_pallas: str = "auto"
    # False keeps the attention scores in the activation dtype
    attn_softmax_f32: bool = True


@dataclass(frozen=True)
class DalleConfig:
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
