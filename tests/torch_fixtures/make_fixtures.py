"""Write the baseline JPEG fixtures of this folder and PIL's decodes of them.

    python tests/torch_fixtures/make_fixtures.py

Each ``<name>.jpg`` is saved by PIL from a seeded, smooth test pattern;
``<name>.npy`` is PIL's ``convert("RGB")`` of it, the oracle the port's
decoder is held to in ``tests/test_torch_image_codec.py`` and in
``chip_smoke.py``'s phase ``train_data``. The names say what each covers.
"""

import io
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

# name: (height, width, PIL save options, grey)
FIXTURES = {
    "ycc420_q90_61x47": (47, 61, dict(quality=90, subsampling=2), False),
    "ycc444_q95_33x29": (29, 33, dict(quality=95, subsampling=0), False),
    "ycc422_q50_45x38": (38, 45, dict(quality=50, subsampling=1), False),
    "grey_q90_23x31": (31, 23, dict(quality=90), True),
    "ycc420_q90_rst_70x52": (52, 70, dict(quality=90, subsampling=2,
                                          restart_marker_blocks=3), False),
}


def pattern(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0),
                  128 + 90 * np.cos(x / 5.0 - y / 9.0),
                  (x * 3 + y * 2) % 256], -1) + rng.randn(h, w, 3) * 12
    return np.clip(a, 0, 255).astype(np.uint8)


def main():
    for seed, (name, (h, w, opts, grey)) in enumerate(sorted(FIXTURES.items())):
        img = Image.fromarray(pattern(h, w, seed))
        if grey:
            img = img.convert("L")
        buf = io.BytesIO()
        img.save(buf, "JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(data)
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.save(os.path.join(HERE, name + ".npy"), ref)


if __name__ == "__main__":
    main()
