"""Pretrained image tokenizers from local files: taming's VQGAN and
OpenAI's discrete VAE.

Port of ``dalle_tpu/models/pretrained.py``. Both architectures are the
port's own modules, and a checkpoint's tensors are renamed onto them:

* ``vqgan_config_from_yaml`` reads taming's config (``model.params`` with
  its ``ddconfig``) with ``read_yaml``, a reader of the YAML subset taming
  writes (block mappings, block and flow lists of scalars, comments): the
  card's machine has no PyYAML.
* ``convert_vqgan_state`` maps a taming ``state_dict``
  (``encoder.down.{l}.block.{i}.…``, ``decoder.up.{l}.upsample.conv``,
  ``encoder.mid.attn_1``, ``quantize.embedding.weight``, …) onto the port's
  ``VQModel`` names; the layouts already agree (NCHW, OIHW). Keys the model
  lacks (the loss's, the discriminator's) are dropped; a missing model key
  raises.
* ``VQGanVAE`` and ``OpenAIDiscreteVAE`` stand behind the VAE contract of
  ``models/wrapper.py``: ``image_size``, ``num_layers``, ``num_tokens``,
  ``get_codebook_indices`` (NHWC images in [0, 1] → (b, n) ids) and
  ``decode``.
* ``OpenAIDiscreteVAE.from_pretrained`` unpickles OpenAI's ``encoder.pkl``
  and ``decoder.pkl`` (whole pickled ``dall_e`` modules) from a local
  directory with ``torch.load(weights_only=False)``, after
  ``install_dall_e_stubs`` has put empty stand-ins for the ``dall_e``
  classes in ``sys.modules``; plain state-dict files load too.

The JAX package downloads the published checkpoints when no path is given.
The port has no network: it raises and names the flags that take local
files. ``--openai_vae_dir`` is the port's flag for the OpenAI pickles.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import VQGANConfig
from ..device import resolve_device
from .vqgan import VQModel, init_vqgan

LOCAL_FLAGS = ("--vqgan_model_path with --vqgan_config_path (a taming checkpoint and its "
               "yaml), --openai_vae_dir (OpenAI's encoder.pkl and decoder.pkl), --vae_path "
               "or --untrained_vae")


def map_pixels(x, eps: float = 0.1):
    """[0, 1] → [ε, 1 - ε] (the logit-laplace domain)."""
    return (1 - 2 * eps) * x + eps


def unmap_pixels(x, eps: float = 0.1):
    """The inverse of ``map_pixels``, clamped to [0, 1]."""
    return torch.clamp((x - eps) / (1 - 2 * eps), 0.0, 1.0)


def no_local_file(what: str) -> FileNotFoundError:
    """The error for a pretrained model that would be a download."""
    return FileNotFoundError(f"{what} is a download, and the port does not download: pass "
                             f"local files with {LOCAL_FLAGS}")


# ---------------------------------------------------------------------------
# taming's YAML subset
# ---------------------------------------------------------------------------

def _scalar(tok: str):
    tok = tok.strip()
    if tok[:1] in ("'", '"') and tok[-1:] == tok[:1] and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in ("null", "~", ""):
        return None
    if low in ("true", "false"):
        return low == "true"
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        return [_scalar(t) for t in inner.split(",")] if inner else []
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if ch in ("'", '"'):
            quote = None if quote == ch else (ch if quote is None else quote)
        elif ch == "#" and quote is None and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def read_yaml(text: str):
    """The YAML subset taming's configs use → nested dicts and lists: block
    mappings by indentation, block lists of scalars (the dash at the key's
    indentation or deeper), flow lists ``[a, b]``, scalars (null, booleans,
    ints, floats, quoted and plain strings), ``#`` comments, one document.
    Anything else raises ValueError."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"tab indentation: {raw!r}")
        lines.append((len(line) - len(line.lstrip()), line.strip()))
    pos = 0

    def block(indent: int):
        nonlocal pos
        if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
            out = []
            while pos < len(lines) and lines[pos][0] == indent and lines[pos][1][:1] == "-":
                item = lines[pos][1][1:].strip()
                if not item or (":" in item and not item.startswith(("'", '"', "["))):
                    raise ValueError(f"only lists of scalars are read: {lines[pos][1]!r}")
                out.append(_scalar(item))
                pos += 1
            return out
        out = {}
        while pos < len(lines) and lines[pos][0] == indent:
            body = lines[pos][1]
            m = re.match(r"""^("[^"]*"|'[^']*'|[^:]+?)\s*:(?:\s+(.*))?$""", body)
            if m is None:
                raise ValueError(f"not a mapping entry: {body!r}")
            key, value = _scalar(m.group(1)), m.group(2)
            pos += 1
            if value is not None and value != "":
                if value[:1] in ("|", ">", "&", "*", "!", "{"):
                    raise ValueError(f"unsupported YAML value: {body!r}")
                out[key] = _scalar(value)
            elif pos < len(lines) and (lines[pos][0] > indent or (
                    lines[pos][0] == indent and lines[pos][1][:1] == "-")):
                out[key] = block(lines[pos][0])
            else:
                out[key] = None
        return out

    if not lines:
        return None
    result = block(lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected indentation at {lines[pos][1]!r}")
    return result


def vqgan_config_from_yaml(path: str) -> VQGANConfig:
    """taming's config yaml (``model.params``: embed_dim, n_embed, ddconfig,
    remap, unknown_index; a ``Gumbel`` target) → ``VQGANConfig``."""
    with open(path, encoding="utf-8") as f:
        y = read_yaml(f.read())
    p = y["model"]["params"]
    dd = p["ddconfig"]
    target = y["model"].get("target", "") or ""
    remap = p.get("remap")
    if isinstance(remap, str):
        remap = tuple(int(i) for i in np.load(remap))
    elif remap is not None:
        remap = tuple(int(i) for i in remap)
    gumbel = "Gumbel" in target
    return VQGANConfig(
        remap_used=remap, remap_unknown=str(p.get("unknown_index", "random")),
        embed_dim=p["embed_dim"], n_embed=p["n_embed"],
        double_z=dd.get("double_z", False), z_channels=dd["z_channels"],
        resolution=dd["resolution"], in_channels=dd["in_channels"], out_ch=dd["out_ch"],
        ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]), num_res_blocks=dd["num_res_blocks"],
        attn_resolutions=tuple(dd["attn_resolutions"]), dropout=dd.get("dropout", 0.0),
        quantizer="gumbel" if gumbel else "vq",
        gumbel_kl_weight=p.get("kl_weight", 5e-4) if gumbel else 5e-4)


# ---------------------------------------------------------------------------
# taming VQGAN checkpoints
# ---------------------------------------------------------------------------

_TAMING_RENAMES = (
    (r"\.(down|up)\.(\d+)\.block\.(\d+)\.", r".\1_\2_block_\3."),
    (r"\.(down|up)\.(\d+)\.attn\.(\d+)\.", r".\1_\2_attn_\3."),
    (r"\.down\.(\d+)\.downsample\.", r".down_\1_downsample."),
    (r"\.up\.(\d+)\.upsample\.", r".up_\1_upsample."),
    (r"\.mid\.(block_1|attn_1|block_2)\.", r".mid_\1."),
    (r"^quantize\.(embedding|embed)\.weight$", "codebook.weight"),
    (r"^quantize\.proj\.", "quant_proj."),
)


def taming_key(key: str) -> str:
    """A taming ``VQModel`` state_dict key → the port's ``VQModel`` key."""
    for pat, rep in _TAMING_RENAMES:
        key = re.sub(pat, rep, key)
    return key


def convert_vqgan_state(state: Dict[str, Any], model: VQModel) -> Dict[str, torch.Tensor]:
    """taming's ``state_dict`` → the state_dict of ``model``: renamed
    (``taming_key``), keys the model lacks dropped; raises KeyError naming
    the model keys the checkpoint does not hold."""
    want = model.state_dict()
    out = {}
    for k, v in state.items():
        name = taming_key(k)
        if name in want:
            out[name] = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"the taming checkpoint lacks {len(missing)} of the model's tensors, "
                       f"e.g. {missing[:4]}")
    return out


class VQGanVAE:
    """A taming VQGAN behind the VAE contract: images in [0, 1] at the
    interface, mapped to [-1, 1] inside; ``decode`` clamps back to [0, 1].
    With ``remap_used`` the vocabulary is the used subset (+1 for the
    'extra' unknown token)."""

    def __init__(self, cfg: VQGANConfig, model: Optional[VQModel] = None, device=None):
        self.cfg = cfg
        self.model = model if model is not None else init_vqgan(cfg, seed=0, device=device)
        self.image_size = cfg.resolution
        self.num_layers = int(math.log2(cfg.resolution // self.model.fmap_size))
        if cfg.remap_used is not None:
            self.num_tokens = len(cfg.remap_used) + (1 if cfg.remap_unknown == "extra" else 0)
        else:
            self.num_tokens = cfg.n_embed

    @property
    def image_fmap_size(self) -> int:
        return self.image_size // (2 ** self.num_layers)

    @classmethod
    def from_pretrained(cls, vqgan_model_path: Optional[str] = None,
                        vqgan_config_path: Optional[str] = None, device=None) -> "VQGanVAE":
        """A taming checkpoint (``.ckpt``, its ``state_dict`` inside, or a
        bare state dict) and its yaml, both local files."""
        if not vqgan_model_path or not vqgan_config_path:
            raise no_local_file("the pretrained taming VQGAN")
        cfg = vqgan_config_from_yaml(vqgan_config_path)
        vae = cls(cfg, device=device)
        ckpt = torch.load(vqgan_model_path, map_location="cpu", weights_only=False)
        state = ckpt.get("state_dict", ckpt)
        with torch.no_grad():
            vae.model.load_state_dict(convert_vqgan_state(state, vae.model))
        return vae

    @torch.no_grad()
    def get_codebook_indices(self, images):
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        images = images.to(self.model.codebook.weight.device)
        return self.model.get_codebook_indices(2.0 * images - 1.0)

    @torch.no_grad()
    def decode(self, ids):
        return torch.clamp((self.model.decode_code(ids) + 1.0) * 0.5, 0.0, 1.0)


# ---------------------------------------------------------------------------
# OpenAI discrete VAE
# ---------------------------------------------------------------------------

class _OpenAIBlock(nn.Module):
    """relu → conv3 three times, relu → conv1, residual; a 1×1 ``id_path``
    when the channel count changes."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        n_hid = n_out // 4
        self.conv_1 = nn.Conv2d(n_in, n_hid, 3, padding=1)
        self.conv_2 = nn.Conv2d(n_hid, n_hid, 3, padding=1)
        self.conv_3 = nn.Conv2d(n_hid, n_hid, 3, padding=1)
        self.conv_4 = nn.Conv2d(n_hid, n_out, 1)
        if n_in != n_out:
            self.id_path = nn.Conv2d(n_in, n_out, 1)

    def forward(self, x):
        h = self.conv_1(torch.relu(x))
        h = self.conv_2(torch.relu(h))
        h = self.conv_3(torch.relu(h))
        h = self.conv_4(torch.relu(h))
        if hasattr(self, "id_path"):
            x = self.id_path(x)
        return x + h


class OpenAIEncoder(nn.Module):
    """conv7 → 4 groups of blocks with a 2× max pool between → relu, 1×1 to
    the vocabulary's logits (8× down). NCHW."""

    def __init__(self, n_hid: int = 256, n_blk_per_group: int = 2, vocab_size: int = 8192):
        super().__init__()
        mults = (1, 1, 2, 4, 8)
        self.n_blk = n_blk_per_group
        self.input = nn.Conv2d(3, n_hid, 7, padding=3)
        ch = n_hid
        for g in range(1, 5):
            for b in range(1, n_blk_per_group + 1):
                self.add_module(f"group_{g}_block_{b}", _OpenAIBlock(ch, n_hid * mults[g]))
                ch = n_hid * mults[g]
        self.output = nn.Conv2d(ch, vocab_size, 1)

    def forward(self, x):
        h = self.input(x)
        for g in range(1, 5):
            for b in range(1, self.n_blk + 1):
                h = getattr(self, f"group_{g}_block_{b}")(h)
            if g < 4:
                h = F.max_pool2d(h, 2, 2)
        return self.output(torch.relu(h))


class OpenAIDecoder(nn.Module):
    """1×1 from the vocabulary's one-hots → 4 groups with a nearest 2×
    upsample between → relu, 1×1 to 2 × channels. NCHW."""

    def __init__(self, n_hid: int = 256, n_init: int = 128, n_blk_per_group: int = 2,
                 out_channels: int = 3, vocab_size: int = 8192):
        super().__init__()
        mults = (0, 8, 4, 2, 1)
        self.n_blk = n_blk_per_group
        self.input = nn.Conv2d(vocab_size, n_init, 1)
        ch = n_init
        for g in range(1, 5):
            for b in range(1, n_blk_per_group + 1):
                self.add_module(f"group_{g}_block_{b}", _OpenAIBlock(ch, n_hid * mults[g]))
                ch = n_hid * mults[g]
        self.output = nn.Conv2d(ch, 2 * out_channels, 1)

    def forward(self, z):
        h = self.input(z)
        for g in range(1, 5):
            for b in range(1, self.n_blk + 1):
                h = getattr(self, f"group_{g}_block_{b}")(h)
            if g < 4:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
        return self.output(torch.relu(h))


def openai_key(key: str) -> str:
    """An openai/DALL-E state_dict key (``blocks.group_1.block_1.res_path.
    conv_1.w``, ``blocks.output.conv.w``, …) → the port's module key."""
    key = key.replace("blocks.", "", 1) if key.startswith("blocks.") else key
    key = re.sub(r"^(group_\d+)\.(block_\d+)\.res_path\.", r"\1_\2.", key)
    key = re.sub(r"^(group_\d+)\.(block_\d+)\.id_path\.", r"\1_\2.id_path.", key)
    key = re.sub(r"^output\.conv\.", "output.", key)
    return re.sub(r"\.w$", ".weight", re.sub(r"\.b$", ".bias", key))


def convert_openai_state(state: Dict[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """An openai/DALL-E encoder or decoder ``state_dict`` → ``model``'s:
    renamed (``openai_key``; the layouts agree, biases flattened), keys the
    model lacks dropped; a missing model key raises KeyError."""
    want = model.state_dict()
    out = {}
    for k, v in state.items():
        name = openai_key(k)
        if name in want:
            out[name] = torch.as_tensor(v).reshape(want[name].shape)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"the OpenAI state lacks {len(missing)} of the model's tensors, "
                       f"e.g. {missing[:4]}")
    return out


def install_dall_e_stubs():
    """Empty ``nn.Module`` stand-ins for the ``dall_e`` package's classes in
    ``sys.modules``, so that OpenAI's pickles (whole pickled modules, not
    state dicts) unpickle without it: pickle restores a module from its
    class and attribute dict without calling ``__init__``. A real
    ``dall_e`` wins; idempotent."""
    import sys
    import types

    if "dall_e" in sys.modules:
        return
    try:
        import dall_e  # noqa: F401
        return
    except ImportError:
        pass

    def make(modname, names):
        mod = types.ModuleType(modname)
        for n in names:
            setattr(mod, n, type(n, (nn.Module,), {"__module__": modname}))
        sys.modules[modname] = mod
        return mod

    pkg = make("dall_e", ())
    pkg.encoder = make("dall_e.encoder", ("Encoder", "EncoderBlock"))
    pkg.decoder = make("dall_e.decoder", ("Decoder", "DecoderBlock"))
    pkg.utils = make("dall_e.utils", ("Conv2d",))


class OpenAIDiscreteVAE:
    """OpenAI's tokenizer behind the VAE contract: 256 px, 3 layers (32×32
    tokens), 8,192 codes. ``get_codebook_indices`` is the argmax of the
    encoder's logits on ``map_pixels(images)``; ``decode`` the sigmoid of
    the decoder's first three channels on the one-hots, unmapped."""

    num_layers = 3

    def __init__(self, encoder: Optional[OpenAIEncoder] = None,
                 decoder: Optional[OpenAIDecoder] = None, device=None, image_size: int = 256):
        """The published architecture unless ``encoder``/``decoder`` are
        given (a smaller one for tests, ``image_size`` to match)."""
        dev = resolve_device(device)
        with torch.device(dev):
            self.encoder = (encoder or OpenAIEncoder()).to(dev).eval()
            self.decoder = (decoder or OpenAIDecoder()).to(dev).eval()
        self.image_size = image_size
        self.num_tokens = self.encoder.output.out_channels

    @property
    def image_fmap_size(self) -> int:
        return self.image_size // (2 ** self.num_layers)

    @classmethod
    def from_pretrained(cls, root: Optional[str] = None, device=None,
                        **arch) -> "OpenAIDiscreteVAE":
        """``root``'s ``encoder.pkl`` and ``decoder.pkl``: OpenAI's pickled
        modules, or plain state dicts; ``arch`` as ``__init__``'s."""
        if not root:
            raise no_local_file("the pretrained OpenAI dVAE")
        install_dall_e_stubs()
        states = []
        for name in ("encoder.pkl", "decoder.pkl"):
            obj = torch.load(os.path.join(root, name), map_location="cpu", weights_only=False)
            states.append(obj.state_dict() if hasattr(obj, "state_dict") else obj)
        return cls.from_state_dicts(*states, device=device, **arch)

    @classmethod
    def from_state_dicts(cls, enc_state: Dict[str, Any], dec_state: Dict[str, Any],
                         device=None, **arch) -> "OpenAIDiscreteVAE":
        vae = cls(device=device, **arch)
        with torch.no_grad():
            vae.encoder.load_state_dict(convert_openai_state(enc_state, vae.encoder))
            vae.decoder.load_state_dict(convert_openai_state(dec_state, vae.decoder))
        return vae

    @torch.no_grad()
    def get_codebook_indices(self, images):
        """[0, 1] NHWC images → (b, 1024) ids."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        x = map_pixels(images.to(self.encoder.input.weight.device)).permute(0, 3, 1, 2)
        idx = torch.argmax(self.encoder(x), dim=1)
        return idx.reshape(idx.shape[0], -1)

    @torch.no_grad()
    def decode(self, ids):
        """(b, n) ids → [0, 1] NHWC images."""
        b, n = ids.shape
        hw = int(n ** 0.5)
        z = F.one_hot(ids.to(self.decoder.input.weight.device), self.num_tokens).float()
        z = z.reshape(b, hw, hw, -1).permute(0, 3, 1, 2)
        out = self.decoder(z)[:, :3]
        return unmap_pixels(torch.sigmoid(out)).permute(0, 2, 3, 1).contiguous()
