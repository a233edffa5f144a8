"""Server-Sent Events framing + streamed grid-row payloads.

Port of ``dalle_tpu/gateway/sse.py``, with the same wire format. SSE (one
long-lived HTTP response, ``text/event-stream``) needs no client library
beyond "read lines" and survives every proxy HTTP does. Each completed grid
row of a request's image token field becomes one ``row`` event the moment
the engine commits it (``DecodeEngine.run(on_rows=...)``); ``done`` carries
the full token sequence (the rows concatenated) and timings.

``RowPixelDecoder`` optionally decodes the committed prefix of the grid
through the port's dVAE into preview pixels per event. The decode runs on
the consumer thread (the HTTP handler writing the stream), never the
engine thread, and on the card on a CUDA stream of its own: the engine
threads dispatch on their replicas' streams, so a preview's host read waits
for the preview's kernels only, and the engine's next dispatch does not
queue behind the decode. The preview band for row r is cropped from a
decode of rows ≤ r (the rows below zero-padded); the decoder's receptive
field reaches across rows, so the band is a preview, not a crop of the
final image: ``done`` is where exactness lives.

Wire format (all payloads single-line JSON):

  event: row   data: {"request_id", "row", "tokens", ["pixels_b64",
                      "pixels_shape"]}
  event: done  data: {"request_id", "tokens", "ttft_s", "latency_s"}
  event: error data: {"request_id", "reason", "detail"}
"""

from __future__ import annotations

import base64
import json
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..serve.pipeline import _device_of, side_stream


def sse_event(event: str, data: dict) -> bytes:
    """One SSE frame. Payloads are compact single-line JSON, so the `data:`
    field never needs the multi-line continuation rules."""
    body = json.dumps(data, separators=(",", ":"))
    assert "\n" not in body
    return f"event: {event}\ndata: {body}\n\n".encode()


def iter_sse(fp) -> Iterator[Tuple[str, dict]]:
    """Parse an SSE byte stream (a ``http.client`` response works) into
    (event, payload) pairs. Stops at EOF."""
    event: Optional[str] = None
    data_lines: List[str] = []
    for raw in fp:
        line = raw.decode() if isinstance(raw, bytes) else raw
        line = line.rstrip("\r\n")
        if line == "":
            if event is not None and data_lines:
                yield event, json.loads("\n".join(data_lines))
            event, data_lines = None, []
            continue
        if line.startswith(":"):
            continue                       # SSE comment / keepalive
        if line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            data_lines.append(line[len("data:"):].strip())
    if event is not None and data_lines:
        yield event, json.loads("\n".join(data_lines))


class RowPixelDecoder:
    """Decode committed grid rows into preview pixel bands.

    Holds per-request accumulated rows; ``row_event(request_id, row, toks)``
    returns the extra payload fields for that row's SSE event: base64 raw
    uint8 RGB of the pixel band the new row maps to. One dVAE decode per
    row per watching client, opt-in via the request's ``"pixels": true``.
    ``vae.decode`` takes (1, fmap²) int64 ids on the vae's device and
    returns (1, H, W, C) pixels in [0, 1]."""

    def __init__(self, vae, image_fmap_size: int):
        self.vae = vae
        self.fmap = int(image_fmap_size)
        self.device = _device_of(vae)
        self._rows: dict = {}              # request_id -> list[int] tokens

    @torch.no_grad()
    def row_event(self, request_id, row: int, tokens: List[int]) -> dict:
        buf = self._rows.setdefault(request_id, [])
        buf.extend(int(t) for t in tokens)
        grid = np.zeros((1, self.fmap * self.fmap), np.int64)
        grid[0, :len(buf)] = buf
        with side_stream(self.device):
            ids = torch.from_numpy(grid).to(self.device)
            images = self.vae.decode(ids).float().cpu().numpy()   # (1, H, W, C)
        px_per_row = images.shape[1] // self.fmap
        band = images[0, row * px_per_row:(row + 1) * px_per_row]
        band8 = (np.clip(band, 0.0, 1.0) * 255).astype(np.uint8)
        return {"pixels_b64": base64.b64encode(band8.tobytes()).decode(),
                "pixels_shape": list(band8.shape)}

    def finish(self, request_id) -> None:
        self._rows.pop(request_id, None)
