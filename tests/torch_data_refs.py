"""Image-text data that the port's data-layer and training-CLI tests write
for themselves: images of several sizes and modes, caption files of one to
three lines (and one empty), and tar shards of such pairs.  Nothing is
downloaded."""
from __future__ import annotations

import io
import tarfile
from pathlib import Path
from typing import List

import numpy as np

WORDS = ("a", "red", "blue", "small", "cat", "dog", "on", "the", "table", "under", "tree", "sky")


def _pixels(rng, h, w, channels):
    """Smooth gradients plus noise: rows that PIL's adaptive filter writes
    with more than one filter type."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * rng.integers(1, 7) + yy * rng.integers(1, 7)) % 256
    planes = [(base * (c + 1) + rng.integers(0, 40, (h, w))) % 256 for c in range(channels)]
    return np.stack(planes, -1).astype(np.uint8)


def captions(rng, k: int) -> str:
    return "\n".join(" ".join(rng.choice(WORDS, int(rng.integers(2, 6)))) for _ in range(k))


def write_pairs(folder: Path, n: int, seed: int = 0, with_pil: bool = True) -> List[str]:
    """n image + caption pairs under `folder` (a subfolder too), stems
    `img000`...: PNGs in RGB, RGBA, L, P (some written by PIL with its
    adaptive filters, some by the port's writer), JPEGs where `with_pil`;
    one caption file empty.  Returns the stems."""
    from dalle_pytorch_tpu_torch.cli.png import write_png

    rng = np.random.default_rng(seed)
    stems = []
    for i in range(n):
        stem = f"img{i:03d}"
        sub = folder / ("nested" if i % 5 == 4 else "")
        sub.mkdir(parents=True, exist_ok=True)
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        kind = ("png_port", "png_rgb", "png_rgba", "png_l", "png_p", "jpeg")[i % 6]
        if not with_pil:
            kind = "png_port"
        if kind == "png_port":
            write_png(sub / f"{stem}.png", _pixels(rng, h, w, 3))
        else:
            from PIL import Image

            if kind == "png_rgb":
                img = Image.fromarray(_pixels(rng, h, w, 3), "RGB")
            elif kind == "png_rgba":
                img = Image.fromarray(_pixels(rng, h, w, 4), "RGBA")
            elif kind == "png_l":
                img = Image.fromarray(_pixels(rng, h, w, 1)[..., 0], "L")
            elif kind == "png_p":
                img = Image.fromarray(_pixels(rng, h, w, 3), "RGB").quantize(colors=40)
            else:
                img = Image.fromarray(_pixels(rng, h, w, 3), "RGB")
            img.save(sub / f"{stem}.{'jpg' if kind == 'jpeg' else 'png'}")
        text = "" if i == 3 else captions(rng, int(rng.integers(1, 4)))
        (sub / f"{stem}.txt").write_text(text)
        stems.append(stem)
    return stems


def write_shard(path: Path, folder: Path) -> None:
    """A tar of every file under `folder`, names relative to it, plus a
    caption without an image and an image without a caption."""
    with tarfile.open(path, "w") as tf:
        for f in sorted(folder.rglob("*")):
            if f.is_file():
                tf.add(f, arcname=str(f.relative_to(folder)))
        lonely = sorted(folder.rglob("*.png"))[0].read_bytes()
        for name, data in (("orphan.txt", b"no image here"), ("lonely.png", lonely)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
