"""The post-decode product pipeline: candidate groups → pixels → rank.

Port of ``dalle_tpu/serve/pipeline.py``. The paper's user flow is text →
many candidate token grids → dVAE pixels → CLIP rerank → the top k. The
decode engine ends at tokens; this is the rest: a small stage runtime that
takes finished candidate groups (all N candidates of one request) through

  * ``decode_pixels``: one batched dVAE decode of the (N, image_seq_len)
    grids → (N, H, W, C) pixels, brought to the host;
  * ``rerank``: one batched CLIP score (``CLIP.score_images``: the text
    tower once a group) after a resize to CLIP's resolution where the dVAE
    decodes at another size; without a CLIP the stage passes zero scores;
  * ``rank``: candidates by score (descending, ties by candidate index),
    the top k with base64 uint8 pixel payloads.

Each stage runs on its own thread behind a bounded queue, so a slow stage
pushes back instead of buffering without bound, and the stages of
different groups overlap. A worker runs its stage on the device of the
model it calls (the vae's, CLIP's), whatever the thread's current CUDA
device, and on the card on a CUDA stream of its own (``side_stream``): a
stage's host read then waits for the stage's kernels only, never for a
decode engine's queued work. Spans ``pipeline/decode_pixels`` and ``pipeline/rerank`` and the
gauges ``pipeline.queue_depth{stage=...}`` go to ``obs``.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import queue as _queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..obs import counter_add, gauge_set, record_span

_STAGES = ("decode_pixels", "rerank")


def prepare_clip_text(text: np.ndarray, clip_cfg) -> np.ndarray:
    """DALL·E prompt ids → CLIP text ids (as ``generate_images`` does): ids
    at or above CLIP's vocabulary (DALL·E's per-position pad remaps) become
    the pad 0, and the context is cropped or 0-padded to CLIP's
    ``text_seq_len``. Returns (1, text_seq_len) int32."""
    text = np.asarray(text, np.int32).reshape(1, -1)
    text = np.where(text >= clip_cfg.num_text_tokens, 0, text)
    n = clip_cfg.text_seq_len
    if text.shape[1] > n:
        text = text[:, :n]
    elif text.shape[1] < n:
        text = np.pad(text, ((0, 0), (0, n - text.shape[1])))
    return text


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """(n, H, W, C) → (n, size, size, C), the JAX package's
    ``jax.image.resize(..., "bilinear")``: a triangle kernel on half-pixel
    centres, widened by the scale when shrinking (antialiased), its weights
    renormalised at the borders."""
    x = images.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1).contiguous()


def _device_of(obj) -> torch.device:
    """The device of the first parameter of a model or of the first module
    an adapter holds."""
    mods = [obj] + [v for v in vars(obj).values() if isinstance(v, torch.nn.Module)]
    for m in mods:
        if isinstance(m, torch.nn.Module):
            p = next(m.parameters(), None)
            if p is not None:
                return p.device
    return torch.device("cpu")


@contextlib.contextmanager
def side_stream(device: torch.device):
    """On the card: the thread's current device set to ``device`` and its
    current stream a side stream that first waits for the work already
    queued on the device's current stream (the weights' writes, an upload
    the caller made); a host read inside waits for this stream's kernels
    only. On the CPU: nothing."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            yield


@dataclasses.dataclass
class CandidateGroup:
    """All N finished candidates of one request, in candidate order;
    ``tokens`` rows are the engine's per-candidate grids."""
    group_id: int
    text: np.ndarray            # (text_seq_len,) int32 prompt ids
    tokens: np.ndarray          # (N, n_tokens) int32
    seeds: List[int]
    top_k: int
    trace_id: Optional[str] = None


@dataclasses.dataclass
class RankedGroup:
    """The pipeline's product: candidates ordered best first."""
    group_id: int
    scores: List[float]         # per candidate, submission order
    order: List[int]            # candidate indices, best first
    top_k: List[dict]           # [{candidate, score, tokens[, pixels_b64,
                                #   pixels_shape]}]
    tokens: np.ndarray          # (N, n_tokens) all candidate grids
    reranked: bool              # CLIP scored (against zero passthrough)
    trace_id: Optional[str] = None
    error: Optional[str] = None


class PendingResult:
    """Handle of one submitted group: ``result(timeout)`` blocks until the
    rank stage (or a stage failure) completes it."""

    def __init__(self):
        self._done = threading.Event()
        self._result: Optional[RankedGroup] = None

    def set(self, result: RankedGroup) -> None:
        self._result = result
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> RankedGroup:
        if not self._done.wait(timeout):
            raise TimeoutError("pipeline result not ready")
        return self._result


class ImagePipeline:
    """``submit(CandidateGroup) -> PendingResult``; ``close()`` drains.

    ``vae`` (a VAE adapter: ``decode(ids) -> NHWC pixels``) enables the
    pixel stage; ``clip`` (a ``models.clip.CLIP``) the rerank, which needs
    the vae (CLIP scores pixels). Without either, groups reach the rank
    stage token-only with zero scores. ``encode_pixels``: whether top-k
    entries carry base64 uint8 RGB payloads."""

    def __init__(self, vae=None, clip=None, *, top_k: Optional[int] = None,
                 maxsize: int = 64, encode_pixels: bool = True):
        self.vae = vae
        self.clip = clip
        self.default_top_k = top_k
        self.encode_pixels = bool(encode_pixels)
        if clip is not None and vae is None:
            raise ValueError("CLIP rerank needs a vae: the scorer "
                             "consumes decoded pixels, not token ids")
        self._qs = {s: _queue.Queue(maxsize=max(1, int(maxsize)))
                    for s in _STAGES}
        self._threads: List[threading.Thread] = []
        self._closed = False
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ImagePipeline":
        with self._lock:
            if self._closed:
                # under the lock: a submit racing close() must not spawn
                # workers that never see the drain sentinel
                raise RuntimeError("pipeline is closed")
            if self._threads:
                return self
            for stage in _STAGES:
                t = threading.Thread(target=self._work, args=(stage,),
                                     name=f"pipeline-{stage}", daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain: queued groups finish, then the workers exit. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads = list(self._threads)
        if threads:
            self._qs[_STAGES[0]].put(None)      # the sentinel cascades forward
        for t in threads:
            t.join(timeout)

    # -- submission --------------------------------------------------------
    def submit(self, group: CandidateGroup, *,
               timeout: float = 30.0) -> PendingResult:
        self.start()                        # raises if closed
        pending = PendingResult()
        # bounded put: a wedged stage surfaces as an error to this caller
        self._put("decode_pixels", (group, pending), timeout=timeout)
        return pending

    def process(self, group: CandidateGroup) -> RankedGroup:
        """Every stage inline on the caller's thread: the same math, no
        queue hops."""
        images = self._decode_stage(group)
        scores, reranked = self._rerank_stage(group, images)
        return self._rank_stage(group, images, scores, reranked)

    # -- stage workers -----------------------------------------------------
    def _put(self, stage: str, item, timeout: Optional[float] = None) -> None:
        q = self._qs[stage]
        try:
            q.put(item, timeout=timeout)
        except _queue.Full:
            raise RuntimeError(
                f"pipeline backlogged: stage {stage!r} queue full "
                f"for {timeout}s") from None
        gauge_set("pipeline.queue_depth", float(q.qsize()),
                  labels={"stage": stage})

    def _work(self, stage: str) -> None:
        q = self._qs[stage]
        while True:
            try:
                # a bounded wait: the sentinel is the normal exit, but the
                # worker looks again on a cadence
                item = q.get(timeout=1.0)
            except _queue.Empty:
                continue
            gauge_set("pipeline.queue_depth", float(q.qsize()),
                      labels={"stage": stage})
            if item is None:                    # drain sentinel: pass it on
                nxt = _STAGES.index(stage) + 1
                if nxt < len(_STAGES):
                    self._qs[_STAGES[nxt]].put(None)
                return
            group, pending = item[0], item[1]
            try:
                if stage == "decode_pixels":
                    images = self._decode_stage(group)
                    self._put("rerank", (group, pending, images))
                else:
                    images = item[2]
                    scores, reranked = self._rerank_stage(group, images)
                    pending.set(self._rank_stage(group, images, scores,
                                                 reranked))
            except Exception as exc:  # noqa: BLE001 - a stage failure
                # completes the waiting request with an error and drops the
                # group; the worker keeps serving the others
                pending.set(RankedGroup(
                    group_id=group.group_id, scores=[], order=[], top_k=[],
                    tokens=group.tokens, reranked=False,
                    trace_id=group.trace_id, error=repr(exc)))

    @torch.no_grad()
    def _decode_stage(self, group: CandidateGroup):
        """(N, H, W, C) f32 pixels on the host, or None without a vae."""
        if self.vae is None:
            return None
        t0 = time.perf_counter()
        dev = _device_of(self.vae)
        with side_stream(dev):
            ids = torch.as_tensor(np.asarray(group.tokens), dtype=torch.long, device=dev)
            images = self.vae.decode(ids).float().cpu().numpy()
        record_span("pipeline/decode_pixels", t0, time.perf_counter() - t0,
                    group_id=group.group_id,
                    candidates=int(group.tokens.shape[0]),
                    trace_id=group.trace_id)
        return images

    @torch.no_grad()
    def _rerank_stage(self, group: CandidateGroup, images):
        n = int(group.tokens.shape[0])
        if self.clip is None or images is None:
            return [0.0] * n, False
        t0 = time.perf_counter()
        cfg = self.clip.cfg
        dev = _device_of(self.clip)
        with side_stream(dev):
            text = torch.from_numpy(prepare_clip_text(group.text, cfg)).to(dev)
            x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(dev)
            vs = cfg.visual_image_size
            if x.shape[1] != vs or x.shape[2] != vs:
                x = resize_bilinear(x, vs)
            scores = self.clip.score_images(text, x).float().cpu().numpy()
        record_span("pipeline/rerank", t0, time.perf_counter() - t0,
                    group_id=group.group_id, candidates=n,
                    trace_id=group.trace_id)
        counter_add("gateway.images_reranked_total", float(n))
        return [float(s) for s in scores], True

    def _rank_stage(self, group: CandidateGroup, images, scores,
                    reranked: bool) -> RankedGroup:
        n = int(group.tokens.shape[0])
        # best score first; equal scores (and the rerank-off zeros) keep
        # submission order
        order = sorted(range(n), key=lambda i: (-scores[i], i))
        k = group.top_k if group.top_k else (self.default_top_k or n)
        top = []
        for i in order[:k]:
            entry = {"candidate": i, "score": scores[i],
                     "tokens": [int(t) for t in group.tokens[i]]}
            if images is not None and self.encode_pixels:
                band8 = (np.clip(images[i], 0.0, 1.0) * 255).astype(np.uint8)
                entry["pixels_b64"] = base64.b64encode(
                    band8.tobytes()).decode()
                entry["pixels_shape"] = list(band8.shape)
            top.append(entry)
        return RankedGroup(group_id=group.group_id, scores=scores,
                           order=order, top_k=top, tokens=group.tokens,
                           reranked=reranked, trace_id=group.trace_id)
