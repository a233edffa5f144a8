"""Continuous-batching serving for DALLE image generation, on the card.

``RequestQueue`` (host FIFO, optionally bounded) → ``SlotScheduler`` (slot ↔
request bookkeeping) → ``DecodeEngine`` (B shared-cache decode slots at
per-row positions, iteration-level refill, a dense slab or a paged block
pool behind a radix prefix cache). ``PolicyQueue`` adds priority/deadline
scheduling. ``ImagePipeline`` takes finished candidate groups through the
dVAE's pixels and CLIP's rerank to the top k. Port of ``dalle_tpu/serve``.
"""

from .engine import DecodeEngine, EngineStats
from .paged import BlockPool, Match, RadixCache
from .pipeline import (CandidateGroup, ImagePipeline, PendingResult,
                       RankedGroup, prepare_clip_text)
from .queue import CompletedRequest, QueueFull, Request, RequestQueue
from .scheduler import (FifoPolicy, PolicyQueue, PriorityDeadlinePolicy,
                        SchedulingPolicy, SlotScheduler)

__all__ = ["DecodeEngine", "EngineStats", "CompletedRequest", "QueueFull",
           "Request", "RequestQueue", "SlotScheduler", "SchedulingPolicy",
           "FifoPolicy", "PriorityDeadlinePolicy", "PolicyQueue",
           "BlockPool", "Match", "RadixCache",
           "CandidateGroup", "ImagePipeline", "PendingResult", "RankedGroup",
           "prepare_clip_text"]
