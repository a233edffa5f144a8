"""DALL·E: the autoregressive text→image transformer.

Port of ``dalle_tpu/models/dalle.py``: per-position pad tokens and <bos>,
tied or untied embeddings, axial positional embeddings when rotary is off,
the static logits allow-mask, the stable-training tricks, and cached
generation with top-k + gumbel sampling, classifier-free guidance (two
caches: conditioned and null-text) and image priming, the draft-and-verify
speculative sampler (``generate_images_tokens_speculative``) and text
completion (``generate_texts_tokens``). The output projection
``to_logits`` is a ``QLinear``, and a tied ``shared_emb`` table may be int8
with per-row scales (``shared_emb_scale``, ``set_shared_emb_int8``): both
the embedding gather and the tied logits product then dequantize (the
latter through the W8 kernel). The VAE is not a
submodule; ``models/wrapper.py`` composes the two. ``forward`` returns the
logits, or with ``return_loss=True`` the training loss
``(loss_text + w·loss_img) / (w + 1)``: f32 cross-entropy over the masked
logits, optionally in sequence chunks recomputed in the backward
(``loss_chunk``), with classifier-free-guidance text dropout
(``null_cond_prob``, or an injected ``null_mask``).

Generation runs eagerly: a Python loop over decode steps, each step one
``Transformer.decode_step`` whose attention is the decode kernel (the JAX
package's dense formula under ``use_kernel=False``). The
``serve_*`` methods are the continuous-batching engine's primitives
(``serve/engine.py``): rows of one shared cache at ragged positions, each
call a ``Transformer.decode_window`` at per-row offsets; a row that must not
be touched passes offset max_seq (its writes drop, its output is discarded).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import DalleConfig
from ..device import resolve_device, to_device
from ..ops.int8w_linear import int8w_linear
from ..ops.quantize_weights import QLinear
from ..ops.sampling import (gumbel_noise, gumbel_sample, gumbel_sample_rows, quiet_spans,
                            top_k_filter)
from .transformer import LN_EPS, DivideMax, Transformer

MASK_VALUE = -1e9  # fill for the logits mask


class AxialPositionalEmbedding(nn.Module):
    """Learned factored 2D position embedding: row + col tables broadcast over
    the grid and summed."""

    def __init__(self, dim: int, shape: Tuple[int, int]):
        super().__init__()
        h, w = shape
        self.row = nn.Parameter(torch.empty(h, 1, dim))
        self.col = nn.Parameter(torch.empty(1, w, dim))

    def forward(self, n: Optional[int] = None):
        emb = (self.row + self.col).reshape(-1, self.row.shape[-1])
        return emb if n is None else emb[:n]


class DALLE(nn.Module):
    """``sp`` > 1 runs the full-sequence forward's attention as ring
    attention over that many ranks (``Transformer``); generation is
    unchanged."""

    def __init__(self, cfg: DalleConfig, sp: int = 1):
        super().__init__()
        c = self.cfg = cfg
        self.num_text_tokens = c.num_text_tokens + c.text_seq_len  # + per-pos pads
        self.total_tokens = self.num_text_tokens + c.image_vocab_size
        self.transformer = Transformer(c.transformer(), sp=sp)
        if c.share_input_output_emb:
            # one (total_tokens, dim) table serves both embeddings and the
            # output projection
            self.shared_emb = nn.Parameter(torch.empty(self.total_tokens, c.dim))
            self.logits_bias = nn.Parameter(torch.zeros(self.total_tokens))
            self.register_buffer("shared_emb_scale", None)
        else:
            self.text_emb = nn.Embedding(self.num_text_tokens, c.dim)
            self.image_emb = nn.Embedding(c.image_vocab_size, c.dim)
            self.to_logits = QLinear(c.dim, self.total_tokens)
        if not c.rotary_emb:
            self.text_pos_emb = nn.Embedding(c.text_seq_len + 1, c.dim)
            self.image_pos_emb = AxialPositionalEmbedding(
                c.dim, (c.image_fmap_size, c.image_fmap_size))
        self.final_norm = nn.LayerNorm(c.dim, eps=LN_EPS)
        self.norm_by_max = DivideMax(dim=-1)
        # static (seq, total_tokens) allow-mask: text positions predict text
        # tokens, image positions image tokens (True = allowed)
        seq = torch.arange(c.total_seq_len)[:, None]
        tok = torch.arange(self.total_tokens)[None, :]
        self.register_buffer(
            "logits_allow", (seq >= c.text_seq_len) == (tok >= self.num_text_tokens),
            persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights drawn from ``generator`` (on the parameters'
        device), in the JAX package's initializers' scales: Dense/Embed
        normal with std 1/sqrt(fan-in) (embeddings: 1/sqrt(dim)), biases 0,
        the tied table N(0, 0.02), axial tables N(0, 1), LayerNorm 1/0."""
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                # Linear weight (out, in), Embedding (num, dim): the last
                # axis is the fan-in / dim in both
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, AxialPositionalEmbedding):
                m.row.normal_(0.0, 1.0, generator=generator)
                m.col.normal_(0.0, 1.0, generator=generator)
        if self.cfg.share_input_output_emb:
            self.shared_emb.normal_(0.0, 0.02, generator=generator)
            self.logits_bias.zero_()
        return self

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the model computes in (its norms'; int8 weights aside)."""
        return self.final_norm.weight.dtype

    def set_shared_emb_int8(self, q: torch.Tensor, scale: torch.Tensor) -> "DALLE":
        """Make the tied table int8: ``q`` (total_tokens, dim) with per-row
        f32 scales ``scale`` (total_tokens, 1)."""
        if q.dtype != torch.int8 or q.shape != self.shared_emb.shape:
            raise ValueError(f"shared_emb must be int8 {tuple(self.shared_emb.shape)}")
        if tuple(scale.shape) != (q.shape[0], 1):
            raise ValueError(f"shared_emb_scale must be ({q.shape[0]}, 1)")
        dev = self.shared_emb.device
        self.shared_emb = nn.Parameter(q.to(dev).contiguous(), requires_grad=False)
        self.shared_emb_scale = scale.to(dev, torch.float32).contiguous()
        return self

    def _apply(self, fn, recurse=True):
        scale = getattr(self, "shared_emb_scale", None)
        super()._apply(fn, recurse)
        if scale is not None:
            # a cast of the model keeps the table's scales f32
            self.shared_emb_scale = scale.to(self.shared_emb.device)
        return self

    def _load_from_state_dict(self, state_dict, prefix, *args):
        q = state_dict.get(prefix + "shared_emb")
        if (q is not None and q.dtype == torch.int8
                and self.shared_emb.dtype != torch.int8):
            scale = state_dict.get(prefix + "shared_emb_scale")
            if scale is not None:
                self.set_shared_emb_int8(torch.empty_like(q),
                                         torch.empty_like(scale, dtype=torch.float32))
        super()._load_from_state_dict(state_dict, prefix, *args)

    # -- embedding helpers -------------------------------------------------
    def _shared_rows(self, ids):
        """Rows of the tied table; an int8 table dequantizes the gathered
        rows in the bias's dtype."""
        rows = self.shared_emb[ids]
        if rows.dtype == torch.int8:
            dt = self.logits_bias.dtype
            rows = rows.to(dt) * self.shared_emb_scale[ids].to(dt)
        return rows

    def _embed_text_ids(self, ids):
        if self.cfg.share_input_output_emb:
            return self._shared_rows(ids)
        return self.text_emb(ids)

    def _embed_image_ids(self, ids):
        if self.cfg.share_input_output_emb:
            return self._shared_rows(ids + self.num_text_tokens)
        return self.image_emb(ids)

    def _logits(self, x):
        x = self.final_norm(x)
        if self.cfg.share_input_output_emb:
            if self.shared_emb.dtype == torch.int8:
                # rows are the tied product's output channels: the W8 kernel
                return int8w_linear(x, self.shared_emb, self.shared_emb_scale[:, 0],
                                    self.logits_bias)
            return x @ self.shared_emb.t() + self.logits_bias
        return self.to_logits(x)

    def remap_and_bos(self, text):
        """0-pads → unique per-position pad ids; prepend <bos>=0. Longer text
        is cropped to text_seq_len, shorter 0-padded."""
        c = self.cfg
        n = text.shape[1]
        if n > c.text_seq_len:
            text = text[:, :c.text_seq_len]
        elif n < c.text_seq_len:
            text = nn.functional.pad(text, (0, c.text_seq_len - n))
        pad_ids = torch.arange(c.text_seq_len, device=text.device) + c.num_text_tokens
        text = torch.where(text == 0, pad_ids[None, :], text)
        return nn.functional.pad(text, (1, 0))  # <bos> id 0

    def embed_text(self, text_with_bos):
        tok = self._embed_text_ids(text_with_bos)
        if not self.cfg.rotary_emb:
            n = text_with_bos.shape[1]
            tok = tok + self.text_pos_emb.weight[:n]
        return tok

    def embed_image(self, image_ids, first_pos: int = 0):
        tok = self._embed_image_ids(image_ids)
        if not self.cfg.rotary_emb:
            n = image_ids.shape[1]
            tok = tok + self.image_pos_emb()[first_pos:first_pos + n]
        return tok

    def _stabilize(self, tokens):
        if self.cfg.stable:  # α-blend trick
            alpha = 0.1
            tokens = tokens * alpha + tokens.detach() * (1 - alpha)
        return tokens

    def _finish(self, x, start: int, n: int):
        """transformer output → logits masked by rows start..start+n of the
        allow-mask."""
        if self.cfg.stable:
            x = self.norm_by_max(x)
        logits = self._logits(x)
        allow = self.logits_allow[start:start + n]
        return torch.where(allow[None], logits, MASK_VALUE)

    def _device(self):
        return self.final_norm.weight.device

    # -- forward -----------------------------------------------------------
    def _ce_chunk(self, x, labels, start: int):
        """Head + f32 cross-entropy for the positions start..start+n (the
        JAX package's ``_ce_chunk_body``)."""
        logits = self._finish(x, start, x.shape[1]).float()
        b, n, vocab = logits.shape
        # flat (b·n, vocab): the softmax runs over the contiguous last axis
        # (a (b, vocab, n) view takes PyTorch's strided "spatial" softmax,
        # several times slower on the card)
        return F.cross_entropy(logits.reshape(b * n, vocab), labels.reshape(b * n),
                               reduction="none").reshape(b, n)

    def forward(self, text, image_ids, return_loss: bool = False, *,
                null_cond_prob: float = 0.0,
                null_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout: bool = False, dropout_masks=None):
        """``text``: (b, text_seq_len) int (0 = pad); ``image_ids``:
        (b, image_seq_len) codebook indices → (b, n, total_tokens) logits,
        or with ``return_loss`` (loss, {"loss_text", "loss_img"}).

        Classifier-free-guidance dropout nulls the text of the rows in
        ``null_mask`` ((b,) bool), or of rows drawn with probability
        ``null_cond_prob`` from ``generator``. ``dropout`` switches the
        transformer's attention and feed-forward dropout on, its masks drawn
        from ``generator`` after the rows (the JAX ``deterministic=False``);
        ``dropout_masks`` (``Transformer.dropout_masks``'s form) injects
        them instead."""
        c = self.cfg
        if text.shape[1] != c.text_seq_len:
            raise ValueError(f"text must be {c.text_seq_len} tokens, got {text.shape[1]}")
        if null_mask is None and null_cond_prob > 0:
            null_mask = torch.rand(text.shape[0], generator=generator,
                                   device=text.device) < null_cond_prob
        if null_mask is not None:
            text = torch.where(null_mask[:, None], 0, text)
        text_b = self.remap_and_bos(text)
        tokens = torch.cat([self.embed_text(text_b), self.embed_image(image_ids)], dim=1)
        tokens = self._stabilize(tokens[:, :c.total_seq_len])
        n = tokens.shape[1]
        if dropout and dropout_masks is None:
            dropout_masks = self.transformer.dropout_masks(tokens.shape[0], n, generator,
                                                           tokens.device)
        out = self.transformer(tokens, dropout_masks=dropout_masks)
        if not return_loss:
            return self._finish(out, 0, n)

        labels = torch.cat([text_b[:, 1:], image_ids + self.num_text_tokens], dim=1)
        if c.loss_chunk > 0 and n % c.loss_chunk != 0:
            raise ValueError(
                f"loss_chunk={c.loss_chunk} must divide the sequence length "
                f"{n} — a silent fall-back would rematerialize the full "
                f"(b, n, vocab) logits the option exists to avoid")
        if c.loss_chunk > 0:
            # each chunk's logits are recomputed in the backward: the full
            # (b, n, vocab) logits are never held
            remat = torch.is_grad_enabled()
            parts = []
            for i in range(0, n, c.loss_chunk):
                args = (out[:, i:i + c.loss_chunk], labels[:, i:i + c.loss_chunk], i)
                parts.append(checkpoint(self._ce_chunk, *args, use_reentrant=False)
                             if remat else self._ce_chunk(*args))
            ce = torch.cat(parts, dim=1)
        else:
            ce = self._ce_chunk(out, labels, 0)
        loss_text = ce[:, :c.text_seq_len].mean()
        loss_img = ce[:, c.text_seq_len:].mean()
        w = c.loss_img_weight
        loss = (loss_text + w * loss_img) / (w + 1)
        return loss, {"loss_text": loss_text, "loss_img": loss_img}

    # -- generation --------------------------------------------------------
    def _prefill(self, text, image_prime, batch: int, dtype=torch.float32,
                 extra_slots: int = 0, use_kernel=None):
        c = self.cfg
        cache = self.transformer.init_cache(batch, c.total_seq_len + extra_slots, dtype)
        tokens = self.embed_text(self.remap_and_bos(text))
        if image_prime is not None and image_prime.shape[1] > 0:
            tokens = torch.cat([tokens, self.embed_image(image_prime)], dim=1)
        tokens = self._stabilize(tokens)
        y, cache = self.transformer.prefill(tokens, cache, use_kernel=use_kernel)
        logits = self._finish(y[:, -1:], tokens.shape[1] - 1, 1)[:, 0]
        return logits, cache, tokens.shape[1]

    def _decode_one(self, token_id, img_pos: int, offset: int, cache, use_kernel=None):
        """Embed the image token sampled at image position ``img_pos`` and
        advance the cache at ``offset``."""
        tok = self._embed_image_ids(token_id[:, None])
        if not self.cfg.rotary_emb:
            tok = tok + self.image_pos_emb()[img_pos:img_pos + 1][None]
        tok = self._stabilize(tok)
        y, cache = self.transformer.decode_step(tok, cache, offset, use_kernel=use_kernel)
        return self._finish(y, offset, 1)[:, 0], cache

    @torch.no_grad()
    def generate_images_tokens(self, text, *, generator: Optional[torch.Generator] = None,
                               noise: Optional[torch.Tensor] = None,
                               filter_thres: float = 0.5, temperature: float = 1.0,
                               cond_scale: float = 1.0,
                               image_prime: Optional[torch.Tensor] = None,
                               cache_dtype=torch.float32, use_kernel=None):
        """AR-sample the image token sequence → (b, image_seq_len) int64.

        Gumbel draws come from ``generator``, or from ``noise`` of shape
        (n_steps, b, image_vocab_size): row i is the draw for the i-th
        sampled token, the last row the final token's (sampled from the last
        logits, with no decode after it). ``cond_scale != 1`` runs
        classifier-free guidance with a second, null-text cache.
        ``image_prime`` (b, n_prime) token ids fix the first image tokens.
        ``cache_dtype`` float32, bfloat16 or int8 (quantized KV).
        ``use_kernel`` pins the decode steps' attend (``cached_attend``):
        None or True the decode kernel K2 (its plain version on the CPU),
        False the JAX package's dense formula, the prefill then attending
        the cache it writes (``Attention.prefill``). Pin False here AND on a serve
        engine for strict bitwise parity between the two, as the JAX
        package says (``dalle_tpu/models/dalle.py:290-296``): K2 and the
        engine's windowed kernels K3/K5 are distinct implementations that
        round at other points, so under ``auto`` the bf16 modes may part at
        a near-tie."""
        c = self.cfg
        dev = self._device()
        text = text.to(dev)
        b = text.shape[0]
        if image_prime is not None:
            image_prime = image_prime.to(dev)
        n_prime = 0 if image_prime is None else image_prime.shape[1]
        n_steps = c.image_seq_len - n_prime
        if noise is not None and tuple(noise.shape) != (n_steps, b, c.image_vocab_size):
            raise ValueError(f"noise must be {(n_steps, b, c.image_vocab_size)}, "
                             f"got {tuple(noise.shape)}")
        use_cfg = cond_scale != 1.0

        logits, cache, prefix_len = self._prefill(text, image_prime, b, cache_dtype,
                                                  use_kernel=use_kernel)
        if use_cfg:
            null_logits, null_cache, _ = self._prefill(torch.zeros_like(text),
                                                       image_prime, b, cache_dtype,
                                                       use_kernel=use_kernel)
            logits = null_logits + (logits - null_logits) * cond_scale

        def sample(logits, i):
            band = top_k_filter(logits[:, self.num_text_tokens:], thres=filter_thres)
            return gumbel_sample(band, temperature=temperature, generator=generator,
                                 noise=None if noise is None else noise[i])

        toks = []
        # the JAX package scans these steps (no sampling span) and samples
        # the last token eagerly (its spans recorded): so does the port
        with quiet_spans():
            for i in range(n_steps - 1):
                tok = sample(logits, i)
                toks.append(tok)
                offset = prefix_len + i
                logits, cache = self._decode_one(tok, n_prime + i, offset, cache, use_kernel)
                if use_cfg:
                    nl, null_cache = self._decode_one(tok, n_prime + i, offset, null_cache,
                                                      use_kernel)
                    logits = nl + (logits - nl) * cond_scale
        toks.append(sample(logits, n_steps - 1))
        out = torch.stack(toks, dim=1)
        if n_prime > 0:
            out = torch.cat([image_prime.to(out.dtype), out], dim=1)
        return out

    @torch.no_grad()
    def generate_images_tokens_speculative(
            self, text, *, gamma: int = 4, draft: str = "row",
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None, filter_thres: float = 0.5,
            temperature: float = 1.0, cache_dtype=torch.float32,
            return_stats: bool = False):
        """Draft-free speculative sampling → (b, image_seq_len) int64. Each
        round drafts ``gamma`` tokens per row with a zero-cost image prior,
        verifies them in one windowed forward of w = gamma+1 tokens
        (``Transformer.decode_window``: K3 on the card) and commits the
        accepted prefix plus one token; rows accept independently, at
        per-row cache offsets. The cache holds total_seq_len + gamma
        positions; a finished row idles at its last step, its writes dropped.

        Exact for any draft quality: token t of row r is always
        argmax(top_k(logits_t)/T + g[t, r]) with logits_t from the committed
        prefix, so rejected drafts cost work, never bias, and gamma=0 is the
        sequential loop under the same draws. ``noise`` (n_steps, b,
        image_vocab_size) holds g: the draw for (step t, row r) is
        ``noise[t, r]`` whatever gamma and whichever round row r reaches t in
        (the JAX package's per-(step, row) fold-in keys map onto it); without
        it the whole table is drawn up front from ``generator``. Candidates
        past the last step only feed windows whose commits are dropped; they
        take the last step's draw.

        ``draft``: "row" = the committed token one grid row above (needs
        gamma < image_fmap_size), "repeat" = the last sampled token. Each
        round reads the rows' accepted counts on the host once (the loop's
        condition), and that read builds the next round's window plan.
        ``return_stats``: also return (rounds, committed tokens)."""
        c = self.cfg
        dev = self._device()
        text = text.to(dev)
        b = text.shape[0]
        n_steps, fmap, vocab = c.image_seq_len, c.image_fmap_size, c.image_vocab_size
        if gamma < 0 or draft not in ("row", "repeat"):
            raise ValueError(f"gamma must be >= 0 and draft 'row' or 'repeat', got "
                             f"{gamma}, {draft!r}")
        if draft == "row" and gamma >= fmap:
            raise ValueError(
                f"'row' draft needs gamma < image_fmap_size ({fmap}); the "
                f"row-above token of a draft slot must already be committed")
        if noise is None:
            noise = gumbel_noise((n_steps, b, vocab), generator=generator, device=dev)
        elif tuple(noise.shape) != (n_steps, b, vocab):
            raise ValueError(f"noise must be {(n_steps, b, vocab)}, got {tuple(noise.shape)}")
        noise = noise.to(dev, torch.float32)
        w = gamma + 1
        rows = torch.arange(b, device=dev)
        allow = self.logits_allow[c.text_seq_len]     # every image row's
        logits, cache, prefix_len = self._prefill(text, None, b, cache_dtype,
                                                  extra_slots=gamma)

        def sample_rows(lg, t):
            g = noise[t.clamp(max=n_steps - 1), rows]
            return gumbel_sample_rows(lg[:, self.num_text_tokens:], g, thres=filter_thres,
                                      temperature=temperature)

        # column n_steps takes the dropped commits
        out = torch.zeros((b, n_steps + 1), dtype=torch.long, device=dev)
        t_idx = np.zeros(b, np.int64)
        rounds = committed = 0
        while (t_idx < n_steps).any():
            t_eff = np.minimum(t_idx, n_steps - 1)            # finished rows idle
            # (w + 2, b): steps t_eff + j for j = 0..w, then whether the row runs
            host = np.concatenate([t_eff[None] + np.arange(w + 1)[:, None],
                                   (t_idx < n_steps)[None].astype(np.int64)])
            steps = to_device(host, dev)
            tok0 = sample_rows(logits, steps[0])
            if gamma:
                p = steps[1:w].t()                              # (b, gamma)
                if draft == "row":
                    above = out.gather(1, (p - fmap).clamp(0, n_steps - 1))
                    drafts = torch.where(p - fmap >= 0, above, tok0[:, None])
                else:
                    drafts = tok0[:, None].expand(b, gamma)
                window = torch.cat([tok0[:, None], drafts], dim=1)
            else:
                window = tok0[:, None]
            emb = self._embed_image_ids(window)
            if not c.rotary_emb:
                emb = emb + self.image_pos_emb()[steps[:w].t().clamp(0, n_steps - 1)]
            y, cache = self.transformer.decode_window(self._stabilize(emb), cache,
                                                      prefix_len + t_eff)
            if c.stable:
                y = self.norm_by_max(y)
            logits_w = torch.where(allow, self._logits(y), MASK_VALUE)     # (b, w, V)
            cands = torch.stack([sample_rows(logits_w[:, j], steps[1 + j])
                                 for j in range(w)], dim=1)
            if gamma:
                acc = torch.cumprod((drafts == cands[:, :gamma]).long(), dim=1).sum(dim=1)
            else:
                acc = torch.zeros(b, dtype=torch.long, device=dev)
            # commit window[:, j] at step t+j for j <= acc, in range, on a running row
            idx = steps[:w].t()
            keep = ((torch.arange(w, device=dev)[None] <= acc[:, None]) & (idx < n_steps)
                    & (steps[w + 1][:, None] > 0))
            out.scatter_(1, torch.where(keep, idx, n_steps), window)
            # the logits after the last committed token: cache slots <= t+acc
            # hold exactly the committed tokens
            logits = logits_w[rows, acc]
            acc_host = acc.cpu().numpy()
            step = np.where(t_idx < n_steps, np.minimum(acc_host + 1, n_steps - t_idx), 0)
            t_idx = t_idx + step
            rounds += 1
            committed += int(step.sum())
        out = out[:, :n_steps]
        if return_stats:
            return out, rounds, committed
        return out

    @torch.no_grad()
    def generate_texts_tokens(self, text=None, *, batch: int = 1,
                              generator: Optional[torch.Generator] = None,
                              noise: Optional[torch.Tensor] = None,
                              filter_thres: float = 0.5, temperature: float = 1.0):
        """Complete a (b, start) text prefix to text_seq_len tokens by
        sampling over the text band (pad ids included) → (b, text_seq_len)
        int64; ``text`` None starts ``batch`` rows from <bos> alone. The
        prefix is <bos> and the given tokens (no pad remap); the cache is
        f32, each step a ``decode_step`` (K2 on the card) at a text
        position. Draws from ``generator``, or ``noise`` (n_new, b,
        num_text_tokens + text_seq_len): row i for the i-th new token."""
        c = self.cfg
        dev = self._device()
        text = (torch.zeros((batch, 0), dtype=torch.long) if text is None
                else torch.as_tensor(text)).to(dev, torch.long)
        b, start = text.shape
        if start >= c.text_seq_len:
            raise ValueError(f"text prefix must be shorter than text_seq_len="
                             f"{c.text_seq_len}, got {start}")
        n_new = c.text_seq_len - start
        vocab = self.num_text_tokens
        if noise is not None and tuple(noise.shape) != (n_new, b, vocab):
            raise ValueError(f"noise must be {(n_new, b, vocab)}, got {tuple(noise.shape)}")
        cache = self.transformer.init_cache(b, c.total_seq_len)
        tokens = self._stabilize(self.embed_text(F.pad(text, (1, 0))))
        y, cache = self.transformer.prefill(tokens, cache)
        logits = self._finish(y[:, -1:], start, 1)[:, 0]

        def sample(lg, i):
            return gumbel_sample(top_k_filter(lg[:, :vocab], thres=filter_thres),
                                 temperature=temperature, generator=generator,
                                 noise=None if noise is None else noise[i])

        toks = []
        with quiet_spans():            # scanned in the JAX package, as above
            for i in range(n_new - 1):
                tok = sample(logits, i)
                toks.append(tok)
                pos = start + 1 + i            # this token's position (after <bos>)
                emb = self._embed_text_ids(tok[:, None])
                if not c.rotary_emb:
                    emb = emb + self.text_pos_emb.weight[pos:pos + 1][None]
                y, cache = self.transformer.decode_step(self._stabilize(emb), cache, pos)
                logits = self._finish(y, pos, 1)[:, 0]
        toks.append(sample(logits, n_new - 1))
        return torch.cat([text, torch.stack(toks, dim=1)], dim=1)


    # -- serving: per-row primitives of the continuous-batching engine ------
    # Masks, offsets and image positions are host arrays: each call builds
    # one WindowPlan (transformer.decode_window) and uploads it once. With
    # the cache's max_seq equal to total_seq_len, every reduction has the
    # width of its sequential counterpart.

    def serve_img_logits(self, y):
        """(b, dim) hidden states → (b, V) masked logits; every served
        position predicts image tokens, so one allow-mask row serves all."""
        return self._finish(y[:, None], self.cfg.text_seq_len, 1)[:, 0]

    def serve_init_cache(self, batch: int, dtype=torch.float32):
        """Shared decode cache for ``batch`` serve slots, max_seq =
        total_seq_len (also the park offset)."""
        return self.transformer.init_cache(batch, self.cfg.total_seq_len, dtype)

    def serve_init_cache_paged(self, num_blocks: int, block_tokens: int,
                               dtype=torch.float32):
        """Paged serve cache: per-layer block pools whose reads cover
        total_seq_len positions."""
        return self.transformer.init_cache_paged(num_blocks, block_tokens,
                                                 self.cfg.total_seq_len, dtype)

    def _ids(self, ids):
        dev = self._device()
        if isinstance(ids, torch.Tensor):
            return ids.to(dev)
        return to_device(np.asarray(ids, np.int64), dev)

    def serve_refill(self, text, cache, refill_mask, use_kernel=None):
        """Admission: prefill the prompts of the ``refill_mask`` rows ((b,)
        host bool) in one multi-row window at [0, prefix_len); the other rows
        park. ``use_kernel`` pins the window's attend. Returns (logits (b, V)
        for each row's first image token, cache)."""
        S = cache["kv_0"].max_seq
        tokens = self._stabilize(self.embed_text(self.remap_and_bos(self._ids(text))))
        offsets = np.where(np.asarray(refill_mask, bool), 0, S)
        y, cache = self.transformer.decode_window(tokens, cache, offsets,
                                                  use_kernel=use_kernel)
        return self.serve_img_logits(y[:, -1]), cache

    def serve_refill_shared(self, text1, cache, refill_mask, cache_dtype=torch.float32,
                            use_kernel=None):
        """Shared-prefix admission: ONE b=1 prefill (``serve_prefill_row``)
        copied into every ``refill_mask`` row of the dense cache. Returns
        (logits (1, V), cache)."""
        logits1, cache1 = self.serve_prefill_row(text1, cache_dtype=cache_dtype,
                                                 use_kernel=use_kernel)
        rows = self._ids(np.flatnonzero(np.asarray(refill_mask, bool)))
        for name, small in cache1.items():
            big = cache[name]
            big.kv[rows] = small.kv
            if big.scale is not None:
                big.scale[rows] = small.scale
        return logits1, cache

    def serve_refill_window(self, ids, cache, refill_mask, start: int,
                            use_kernel=None):
        """Chunked-prefill admission: one window of already remapped+bos'd
        prompt ids (b, w) written at [start, start+w) of the ``refill_mask``
        rows; ``use_kernel`` pins its attend. Returns (logits (b, V) from the
        window's last position, cache)."""
        S = cache["kv_0"].max_seq
        ids = self._ids(ids)
        tok = self._embed_text_ids(ids)
        if not self.cfg.rotary_emb:
            tok = tok + self.text_pos_emb.weight[start:start + ids.shape[1]]
        offsets = np.where(np.asarray(refill_mask, bool), start, S)
        y, cache = self.transformer.decode_window(self._stabilize(tok), cache, offsets,
                                                  use_kernel=use_kernel)
        return self.serve_img_logits(y[:, -1]), cache

    def serve_prefill_row(self, text, cache_dtype=torch.float32, use_kernel=None):
        """Single-request prefill, the sequential ``_prefill``: (1,
        text_seq_len) text → (logits (1, V), a fresh b=1 cache)."""
        logits, cache, _ = self._prefill(self._ids(text), None, 1, cache_dtype,
                                         use_kernel=use_kernel)
        return logits, cache

    def serve_decode(self, tok, img_pos, offsets, cache, use_kernel=None):
        """One decode step for every slot: ``tok`` (b,) image token ids on
        the device, ``img_pos`` (b,) image grid positions and ``offsets``
        (b,) cache positions on the host (parked rows pass max_seq);
        ``use_kernel`` pins the attend. Returns (logits (b, V), cache)."""
        c = self.cfg
        emb = self._embed_image_ids(tok[:, None])
        if not c.rotary_emb:
            pos = np.clip(np.asarray(img_pos, np.int64), 0, c.image_seq_len - 1)
            emb = emb + self.image_pos_emb()[self._ids(pos)][:, None]
        y, cache = self.transformer.decode_window(self._stabilize(emb), cache, offsets,
                                                  use_kernel=use_kernel)
        return self.serve_img_logits(y[:, 0]), cache


def init_dalle(cfg: DalleConfig, *, seed: int = 0, device=None, sp: int = 1) -> DALLE:
    """A DALLE with random weights from a seeded ``torch.Generator``, built
    directly on ``device`` (default: the CUDA card; pass "cpu" explicitly);
    ``sp`` as in ``DALLE``."""
    dev = resolve_device(device)
    with torch.device(dev):
        # the buffers made from numpy tables (rotary, static masks) ignore
        # the default device; .to moves them, the parameters are there already
        model = DALLE(cfg, sp=sp).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.reset_parameters(gen).eval()
