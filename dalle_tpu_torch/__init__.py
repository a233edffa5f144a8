"""dalle_tpu_torch: the PyTorch/CUDA port of dalle_tpu for NVIDIA Hopper.

Text token ids → image tokens → pixels: ``DALLE`` generates image tokens
with a KV cache whose decode attention is a hand-written CUDA kernel
(``ops/decode_attention.py``, ``csrc/decode_attention.cu``), and
``DalleWithVae.generate_images`` decodes them to pixels through the dVAE.
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
Importing the package builds nothing; kernels are compiled at first use.
"""

from .config import DalleConfig, DVAEConfig, TransformerConfig, dalle_1p4b
from .convert import dalle_state_dict, dvae_state_dict
from .device import resolve_device
from .models.dalle import DALLE, init_dalle
from .models.dvae import DiscreteVAE, init_dvae
from .models.wrapper import DalleWithVae, DiscreteVAEAdapter

__all__ = ["DalleConfig", "DVAEConfig", "TransformerConfig", "dalle_1p4b",
           "dalle_state_dict", "dvae_state_dict", "resolve_device", "DALLE",
           "init_dalle", "DiscreteVAE", "init_dvae", "DalleWithVae",
           "DiscreteVAEAdapter"]
