"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere. The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit (the repository's conftest
imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: an f32 cache runs the kernel in f32 like the plain version, so
only the summation order differs (2e-5 on O(1) outputs). bf16 and int8
caches take a bf16 query and write a bf16 output, as on the main path, so
the two differ by up to one bf16 rounding of an O(1) value (1.6e-2).
"""

import numpy as np
import pytest
import torch

from dalle_tpu_torch.config import DalleConfig
from dalle_tpu_torch.models.dalle import init_dalle
from dalle_tpu_torch.ops import decode_attention as dec
from dalle_tpu_torch.ops.attention import KVCache, cached_attend
from dalle_tpu_torch.ops.attn_masks import build_mask

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2, torch.int8: 1.6e-2}
TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4,
            dim_head=16, image_size=16, image_vocab_size=48, image_fmap_size=4)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cache(b, h, S, d, dtype, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    k = torch.randn(b, h, S, d, device="cuda", generator=gen)
    v = torch.randn(b, h, S, d, device="cuda", generator=gen)
    q = torch.randn(b, h, 1, d, device="cuda", generator=gen)
    q = q.to(torch.float32 if dtype == torch.float32 else torch.bfloat16)
    return q, KVCache.init(b, h, S, d, dtype, device="cuda").append(k, v, 0)


@pytest.mark.parametrize("shape", [(8, 14, 128, 512), (3, 6, 64, 300),
                                   (2, 3, 32, 17), (1, 2, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_matches_plain(dtype, shape):
    b, h, d, S = shape
    q, cache = _cache(b, h, S, d, dtype, seed=d + S)
    for length in sorted({1, S // 2 + 1, S}):
        before = dec.launches
        out = dec.decode_attend(q, cache, length)
        assert dec.launches == before + 1
        ref = dec.decode_attend_plain(q, cache.kv, cache.scale, length)
        torch.cuda.synchronize()
        assert out.dtype == q.dtype and out.shape == q.shape
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype], (length, err)


@pytest.mark.parametrize("attn_type", ["axial_row", "axial_col", "conv_like"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_with_static_mask_rows_matches_plain(dtype, attn_type):
    text_len, fmap = 17, 4
    S = text_len + fmap * fmap - 1
    mask = torch.from_numpy(build_mask(attn_type, text_len, fmap, kernel_size=3)
                            .astype(np.int32)).cuda()
    q, cache = _cache(2, 4, S, 32, dtype, seed=1)
    for qpos in (0, text_len - 1, text_len + 3, S - 1):
        out = cached_attend(q, cache, qpos + 1, static_mask=mask, qpos=qpos)
        ref = dec.decode_attend_plain(q, cache.kv, cache.scale, qpos + 1,
                                      mask_row=mask[qpos])
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_kernel_with_no_valid_position_writes_zero():
    q, cache = _cache(1, 2, 16, 32, torch.float32, seed=2)
    out = dec.decode_attend(q, cache, 8, mask_row=torch.zeros(16, dtype=torch.int32,
                                                              device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_wrapper_raises_instead_of_falling_back():
    q, cache = _cache(1, 2, 16, 32, torch.float32, seed=3)
    with pytest.raises(ValueError):
        dec.decode_attend(q[..., ::2], cache, 4)        # strided, d mismatch
    with pytest.raises(ValueError):
        dec.decode_attend(q, cache, 4, mask_row=torch.ones(16, dtype=torch.bool,
                                                           device="cuda"))


@pytest.mark.parametrize("rotary_emb", [True, False])
def test_cached_decode_on_the_card_equals_forward(rotary_emb):
    """The whole decode path on the card, through the kernel: cached logits
    at every image position equal the uncached forward's (f32, 1e-4)."""
    cfg = DalleConfig(**TINY, rotary_emb=rotary_emb,
                      attn_types=("full", "axial_row"))
    model = init_dalle(cfg, seed=5)
    gen = torch.Generator("cuda").manual_seed(6)
    text = torch.randint(1, cfg.num_text_tokens, (2, cfg.text_seq_len),
                         device="cuda", generator=gen)
    img = torch.randint(0, cfg.image_vocab_size, (2, cfg.image_seq_len),
                        device="cuda", generator=gen)
    before = dec.launches
    with torch.no_grad():
        full = model(text, img)[:, cfg.text_seq_len:]
        logits, cache, plen = model._prefill(text, None, 2)
        steps = [logits]
        for i in range(cfg.image_seq_len - 1):
            logits, cache = model._decode_one(img[:, i], i, plen + i, cache)
            steps.append(logits)
    assert dec.launches - before == cfg.depth * (cfg.image_seq_len - 1)
    err = (torch.stack(steps, 1) - full).abs().max().item()
    assert err <= 1e-4
