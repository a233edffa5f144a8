"""The port's product pipeline ≡ the JAX package's (CPU, tiny sizes).

A JAX dVAE (16 px, 48 codes) and CLIP (8 px with 4 px patches, so the
rerank stage resizes the dVAE's pixels down) drawn from numpy, converted to
the port: ``ImagePipeline`` gives the JAX pipeline's top-k order, its
scores within 1e-4, its pixels within the 1e-4 the dVAE tests hold
(``tests/test_torch_cli.py``) and its base64 uint8 payloads within 1 (a
pixel within 1e-4 of a quantization step may round to either side);
through ``process`` and through the threaded stages. ``prepare_clip_text``
is exact; the stage's resize lies within 1e-5 of ``jax.image.resize(...,
"bilinear")`` shrinking and growing. Without models the order is
submission order with zero scores; a failing stage completes its group
with an error and the worker serves the next; ``close`` drains what is
queued; ``DalleWithVae.image_pipeline`` wires the wrapper's vae and CLIP.
"""

import base64
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.config import ClipConfig as JClipConfig
from dalle_tpu.config import DVAEConfig as JDVAEConfig
from dalle_tpu.models.clip import CLIP as JCLIP
from dalle_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from dalle_tpu.models.wrapper import DiscreteVAEAdapter as JAdapter
from dalle_tpu.serve import pipeline as jpipe
from dalle_tpu_torch import (CLIP, ClipConfig, DalleWithVae, DiscreteVAE, DiscreteVAEAdapter,
                             DVAEConfig, clip_state_dict, dvae_state_dict)
from dalle_tpu_torch import obs as tobs
from dalle_tpu_torch.serve import (CandidateGroup, ImagePipeline, PendingResult, RankedGroup,
                                   prepare_clip_text)
from dalle_tpu_torch.serve.pipeline import resize_bilinear

VAE = dict(image_size=16, num_tokens=48, codebook_dim=16, num_layers=2, hidden_dim=8)
CLIP_KW = dict(dim_text=32, dim_image=32, dim_latent=32, num_text_tokens=100,
               text_enc_depth=1, text_seq_len=8, text_heads=2, visual_enc_depth=1,
               visual_heads=2, visual_image_size=8, visual_patch_size=4)
PIXEL_TOL = 1e-4
SCORE_TOL = 1e-4


def _random_params(model, args, seed, **kw):
    """numpy weights on the flax tree's shapes: kernels N(0, 1/fan-in),
    embeddings N(0, 0.5²), norm scales near 1, the rest N(0, 0.1²)."""
    keys = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(0)}
    shapes = jax.eval_shape(lambda: model.init(keys, *args, **kw))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        if name == "embedding":
            return x * np.float32(0.5)
        if name == "scale":
            return 1 + np.float32(0.1) * x
        return x * np.float32(0.1)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models():
    jv = JDiscreteVAE(JDVAEConfig(**VAE))
    jvp = _random_params(jv, (jnp.zeros((1, 16, 16, 3)),), 1, return_loss=True)
    jc = JCLIP(JClipConfig(**CLIP_KW))
    jcp = _random_params(jc, (jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8, 8, 3))), 2,
                         return_loss=True)
    tv = DiscreteVAE(DVAEConfig(**VAE))
    tv.load_state_dict(dvae_state_dict(jvp))
    tc = CLIP(ClipConfig(**CLIP_KW))
    tc.load_state_dict(clip_state_dict(jcp))
    return (JAdapter(jv, jvp), jc, jcp), (DiscreteVAEAdapter(tv.eval()), tc.eval())


def _group(gid, n=6, top_k=3, seed=0):
    rng = np.random.RandomState(seed)
    text = np.array([5, 120, 7, 0, 0, 0, 0, 0, 0, 0], np.int32)    # 120 ≥ CLIP's vocab
    return CandidateGroup(group_id=gid, text=text,
                          tokens=rng.randint(0, 48, (n, 16)).astype(np.int32),
                          seeds=list(range(n)), top_k=top_k, trace_id=f"g{gid}")


def _jgroup(g):
    return jpipe.CandidateGroup(group_id=g.group_id, text=g.text, tokens=g.tokens,
                                seeds=g.seeds, top_k=g.top_k, trace_id=g.trace_id)


def _payload(entry):
    return np.frombuffer(base64.b64decode(entry["pixels_b64"]), np.uint8).reshape(
        entry["pixels_shape"])


def _same_ranking(got: RankedGroup, want):
    assert got.error is None and want.error is None
    assert got.order == want.order and got.reranked and want.reranked
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=SCORE_TOL)
    assert [e["candidate"] for e in got.top_k] == [e["candidate"] for e in want.top_k]
    for a, b in zip(got.top_k, want.top_k):
        assert a["tokens"] == b["tokens"] and a["pixels_shape"] == b["pixels_shape"]
        assert np.abs(_payload(a).astype(int) - _payload(b).astype(int)).max() <= 1


def test_pipeline_matches_jax(models):
    (jvae, jc, jcp), (tvae, tc) = models
    jp = jpipe.ImagePipeline(vae=jvae, clip=jc, clip_params=jcp, top_k=3)
    tp = ImagePipeline(vae=tvae, clip=tc, top_k=3)
    g = _group(0)
    want = jp.process(_jgroup(g))
    _same_ranking(tp.process(g), want)
    np.testing.assert_allclose(tp._decode_stage(g), np.asarray(jp._decode_stage(_jgroup(g))),
                               rtol=0, atol=PIXEL_TOL)
    # the threaded stages: two groups, each ranked as JAX ranks it alone
    groups = [_group(1, seed=1), _group(2, n=4, top_k=0, seed=2)]
    tobs.disable()
    tobs.configure()
    try:
        pending = [tp.submit(gr) for gr in groups]
        got = [p.result(timeout=60) for p in pending]
        spans = tobs.get_tracer().snapshot_spans()
        metrics = tobs.metrics_snapshot()
    finally:
        tp.close(timeout=10)
        tobs.disable()
    for gr, r in zip(groups, got):
        _same_ranking(r, jp.process(_jgroup(gr)))
        assert r.trace_id == gr.trace_id
    assert len(got[1].top_k) == 3                     # top_k 0: the pipeline's
    names = sorted(name for name, *_ in spans)
    assert names == ["pipeline/decode_pixels"] * 2 + ["pipeline/rerank"] * 2
    assert {'pipeline.queue_depth{stage="decode_pixels"}', 'pipeline.queue_depth{stage="rerank"}',
            "gateway.images_reranked_total"} <= set(metrics)
    assert metrics["gateway.images_reranked_total"] == 10.0


def test_prepare_clip_text_is_exact():
    cfg = ClipConfig(**CLIP_KW)
    jcfg = JClipConfig(**CLIP_KW)
    for text in (np.array([5, 120, 7, 0], np.int32), np.arange(1, 13, dtype=np.int32) * 11,
                 np.zeros((8,), np.int32)):
        got, want = prepare_clip_text(text, cfg), jpipe.prepare_clip_text(text, jcfg)
        assert got.dtype == want.dtype and got.shape == want.shape == (1, 8)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [8, 5, 11, 1, 24, 37], ids=lambda s: f"to{s}")
def test_resize_matches_jax_image_resize(size):
    x = np.random.RandomState(size).rand(2, 16, 16, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_without_models_the_order_is_submission_order():
    pipe = ImagePipeline(top_k=2)
    try:
        got = [pipe.submit(_group(i, n=3, top_k=0)) for i in range(3)]
        res = [p.result(timeout=30) for p in got]
    finally:
        pipe.close(timeout=10)
    for i, r in enumerate(res):
        assert (r.group_id, r.order, r.scores, r.reranked) == (i, [0, 1, 2], [0.0] * 3, False)
        assert [e["candidate"] for e in r.top_k] == [0, 1] and "pixels_b64" not in r.top_k[0]
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(_group(9))
    with pytest.raises(ValueError, match="needs a vae"):
        ImagePipeline(clip=object())


def test_a_failing_stage_completes_its_group_and_the_worker_goes_on(models):
    _, (tvae, tc) = models

    class Flaky:
        """The vae, failing on group 1."""
        model = tvae.model

        def decode(self, ids):
            if ids.shape[0] == 5:
                raise RuntimeError("decoder fault")
            return tvae.decode(ids)

    pipe = ImagePipeline(vae=Flaky(), clip=tc)
    try:
        res = [pipe.submit(_group(i, n=5 if i == 1 else 3)).result(timeout=30) for i in range(3)]
    finally:
        pipe.close(timeout=10)
    assert "decoder fault" in res[1].error and res[1].order == [] and not res[1].reranked
    assert res[0].error is None and res[2].error is None and res[2].reranked


def test_close_drains_what_is_queued(models):
    _, (tvae, tc) = models
    gate = threading.Event()

    class Slow:
        model = tvae.model

        def decode(self, ids):
            gate.wait(30)
            return tvae.decode(ids)

    pipe = ImagePipeline(vae=Slow(), clip=tc, maxsize=8)
    pending = [pipe.submit(_group(i, n=2)) for i in range(4)]
    closer = threading.Thread(target=pipe.close)
    closer.start()
    gate.set()
    closer.join(60)
    assert not closer.is_alive()
    assert all(isinstance(p, PendingResult) and p.result(timeout=0).error is None
               for p in pending)
    assert not any(t.is_alive() for t in pipe._threads)
    pipe.close()                                              # idempotent


def test_wrapper_builds_the_pipeline(models):
    _, (tvae, tc) = models
    wrapper = DalleWithVae(None, tvae).attach_rerank(tc)
    pipe = wrapper.image_pipeline(top_k=2, encode_pixels=False)
    assert pipe.vae is tvae and pipe.clip is tc and pipe.default_top_k == 2
    r = pipe.process(_group(3, top_k=0))
    assert len(r.top_k) == 2 and "pixels_b64" not in r.top_k[0] and r.reranked
