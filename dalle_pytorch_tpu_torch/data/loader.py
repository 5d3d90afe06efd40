"""The host-side image-text data layer (counterpart of
`dalle_pytorch_tpu/data/loader.py`).

A folder of images with same-stem `.txt` caption files (`TextImageDataset`,
`iterate_batches`) or local `.tar` shards of such pairs
(`iterate_tar_shards`, `batch_tar_stream`), each sample a random caption
line tokenized and a random resized square crop.  Batches are
{'text': (B, text_len) int64, 'image': (B, H, W, C) float32 in [0, 1]}
numpy arrays; a folder of images alone (`ImageDataset`,
`iterate_image_batches`, the VAE's data) gives (B, H, W, C) arrays.  All
are equal to the JAX loader's on the same files and seed: the
same per-item `random.Random` draws, the same shuffle, and a crop whose
bilinear resize is PIL's `Image.resize(..., BILINEAR, box=...)` bit for bit
(`resize_bilinear`: PIL's fixed-point two-pass resampler, in numpy).

PNG decodes through the port's own reader (`cli/png.py`), so the card's
machine, which has no PIL, reads it.  JPEG and BMP go through PIL where it
imports; where it does not, they are refused with a `SystemExit` naming the
first such file, never skipped.  A remote shard spec (http, https, gs) is
refused by name: neither machine has a network (ROADMAP.md Queue 1 item
10).  Files that are truly broken (a bad CRC, a truncated stream) are
reported and skipped, as the JAX loader skips them.
"""
from __future__ import annotations

import collections
import io
import math
import random
import re
import tarfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dalle_pytorch_tpu_torch.cli import png

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp")
_WAITING = "ROADMAP.md Queue 1 item 10"
# PIL's fixed-point resampling: 32 bits less 8 of a sample less 2 of headroom
_PRECISION_BITS = 32 - 8 - 2


class BrokenImage(Exception):
    """An image file that cannot be decoded: the sample is skipped."""


def _pil_image():
    """PIL's `Image` module, or None where PIL does not import."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _refuse_without_pil(name: str) -> SystemExit:
    return SystemExit(f"{name}: decoding JPEG or BMP needs PIL, which this machine does not have; only PNG is "
                      f"read without it ({_WAITING})")


def _refuse_unless_readable(files: Iterable[Path]) -> None:
    """Without PIL, exit naming the first of `files` that is not a PNG."""
    if _pil_image() is not None:
        return
    for path in files:
        with open(path, "rb") as f:
            if not f.read(len(png._SIGNATURE)).startswith(png._SIGNATURE):
                raise _refuse_without_pil(str(path))


def decode_image(data: bytes, name: str, mode: str) -> np.ndarray:
    """(H, W, 3) uint8 for mode "RGB", (H, W, 4) for "RGBA": the pixels of
    PIL's `Image.open(...).convert(mode)`.  PNG through `cli/png.py`,
    anything else through PIL, or a `SystemExit` without it.  A PNG that
    the reader refuses (16-bit, interlaced) exits naming the file; a broken
    file raises `BrokenImage`."""
    if data.startswith(png._SIGNATURE):
        try:
            return png.convert(png.decode_png(data, name), mode)
        except png.PngUnsupported as e:
            raise SystemExit(str(e)) from e
        except (ValueError, zlib.error) as e:
            raise BrokenImage(f"{name}: {e}") from e
    image = _pil_image()
    if image is None:
        raise _refuse_without_pil(name)
    try:
        with image.open(io.BytesIO(data)) as img:
            return np.asarray(img.convert(mode))
    except OSError as e:  # PIL's UnidentifiedImageError is an OSError
        raise BrokenImage(f"{name}: {e!r}") from e


# ---------------------------------------------------------------------------
# PIL's bilinear resize
# ---------------------------------------------------------------------------


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _coefficients(in_size: int, in0: float, in1: float, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first tap (out,), taps (out,), int64 weights (out, ksize)) of one
    axis, as PIL's `precompute_coeffs` and `normalize_coeffs_8bpc` make
    them: the filter's support widened by the downscale factor, weights
    normalised in double precision, then turned to 22-bit fixed point."""
    scale = (in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    taps = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = in0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # int() truncates toward zero, as C's cast
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bilinear((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        first[xx], taps[xx] = xmin, xmax
        weights[xx, :xmax] = [int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0 else
                              int(0.5 + w * (1 << _PRECISION_BITS)) for w in k]
    return first, taps, weights


def _resample(src: np.ndarray, first: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """One pass over `axis` (1: columns, 0: rows) of a uint8 (H, W, C)
    image: each output sample rounds 2^21 + sum(in * w) down by 22 bits
    and clips to 0..255, as PIL's `clip8`."""
    n_in = src.shape[axis]
    acc = np.full(src.shape[:axis] + (len(first),) + src.shape[axis + 1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, n_in - 1)  # taps past a row's count weigh 0
        w = weights[:, t]
        taken = np.take(src, idx, axis=axis).astype(np.int64)
        acc += taken * (w[None, :, None] if axis == 1 else w[:, None, None])
    return np.where(acc <= 0, 0, np.minimum(acc >> _PRECISION_BITS, 255)).astype(np.uint8)


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBA -> RGBa: each colour times alpha / 255, rounded as its
    MULDIV255."""
    a = rgba[..., 3:].astype(np.int64)
    tmp = rgba[..., :3].astype(np.int64) * a + 128
    return np.concatenate([((tmp >> 8) + tmp) >> 8, a], axis=-1).astype(np.uint8)


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA: colours times 255 / alpha (integer division,
    clipped), kept as they are where alpha is 0 or 255."""
    a = rgba[..., 3:].astype(np.int64)
    c = rgba[..., :3].astype(np.int64)
    scaled = np.minimum(255 * c // np.maximum(a, 1), 255)
    return np.concatenate([np.where((a == 0) | (a == 255), c, scaled), a], axis=-1).astype(np.uint8)


def _resize_channels(pixels: np.ndarray, size: Tuple[int, int], box: Tuple[int, int, int, int]) -> np.ndarray:
    """PIL's `ImagingResampleInner` on 8-bit channels: the horizontal pass
    over the rows the vertical pass reads, into a uint8 image, then the
    vertical pass; a pass is skipped where its axis keeps size and box."""
    h, w = pixels.shape[:2]
    xsize, ysize = size
    x0, y0, x1, y1 = (float(v) for v in box)
    first_h, _, weights_h = _coefficients(w, x0, x1, xsize)
    first_v, taps_v, weights_v = _coefficients(h, y0, y1, ysize)
    out = pixels
    if xsize != w or x0 != 0 or x1 != xsize:
        ybox_first, ybox_last = int(first_v[0]), int(first_v[-1] + taps_v[-1])
        out = _resample(pixels[ybox_first:ybox_last], first_h, weights_h, axis=1)
        first_v = first_v - ybox_first
    if ysize != h or y0 != 0 or y1 != ysize:
        out = _resample(out, first_v, weights_v, axis=0)
    return out


def resize_bilinear(pixels: np.ndarray, size: Tuple[int, int], box: Tuple[int, int, int, int]) -> np.ndarray:
    """PIL's `Image.resize(size, BILINEAR, box=box)` of a uint8 (H, W, 3)
    RGB or (H, W, 4) RGBA image, bit for bit; RGBA is resized
    premultiplied, as PIL does.  size is (width, height); box (x0, y0, x1,
    y1) in source pixels."""
    h, w = pixels.shape[:2]
    if (w, h) == tuple(size) and tuple(box) == (0, 0, w, h):
        return pixels.copy()
    if pixels.shape[-1] == 4:
        return _unpremultiply(_resize_channels(_premultiply(pixels), size, box))
    return _resize_channels(pixels, size, box)


def random_resized_crop(pixels: np.ndarray, size: int, rng: random.Random,
                        scale: Tuple[float, float] = (0.75, 1.0),
                        ratio: Tuple[float, float] = (1.0, 1.0)) -> np.ndarray:
    """The JAX loader's square random resized crop of a uint8 (H, W, C)
    image, with its draws from `rng`: up to ten tries of an area and an
    aspect ratio, a box that fits, resized to (size, size); a centre crop
    when no try fits."""
    h, w = pixels.shape[:2]
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = rng.uniform(*ratio)
        cw = int(round((target * ar) ** 0.5))
        ch = int(round((target / ar) ** 0.5))
        if cw <= w and ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            return resize_bilinear(pixels, (size, size), (x, y, x + cw, y + ch))
    side = min(w, h)
    x, y = (w - side) // 2, (h - side) // 2
    return resize_bilinear(pixels, (size, size), (x, y, x + side, y + side))


def image_to_array(pixels: np.ndarray) -> np.ndarray:
    """uint8 (H, W, C) -> float32 in [0, 1], as the JAX loader's
    `np.asarray(img, dtype=np.float32) / 255.0`."""
    return pixels.astype(np.float32) / 255.0


# ---------------------------------------------------------------------------
# the image-text folder
# ---------------------------------------------------------------------------


class TextImageDataset:
    """A folder of images and same-stem `.txt` caption files (searched
    recursively; a stem with both is a sample, in sorted stem order)."""

    def __init__(self, folder: str, text_len: int = 256, image_size: int = 128, truncate_captions: bool = False,
                 resize_ratio: float = 0.75, transparent: bool = False, tokenizer=None, shuffle: bool = False,
                 seed: int = 0):
        path = Path(folder)
        text_files = {f.stem: f for f in path.glob("**/*.txt")}
        image_files = {f.stem: f for suffix in IMAGE_SUFFIXES for f in path.glob(f"**/*{suffix}")}
        keys = sorted(image_files.keys() & text_files.keys())
        self.keys = keys
        self.text_files = {k: text_files[k] for k in keys}
        self.image_files = {k: image_files[k] for k in keys}
        self.text_len = text_len
        self.image_size = image_size
        self.truncate_captions = truncate_captions
        self.resize_ratio = resize_ratio
        self.mode = "RGBA" if transparent else "RGB"
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self._rng = random.Random(seed)
        _refuse_unless_readable(self.image_files[key] for key in keys)  # up front, not mid-epoch

    def __len__(self) -> int:
        return len(self.keys)

    def _skip(self, ind: int, rng: random.Random):
        if self.shuffle:
            return self.get(rng.randint(0, len(self) - 1), rng)
        return self.get(0 if ind >= len(self) - 1 else ind + 1, rng)

    def get(self, ind: int, rng: random.Random):
        """One sample with the given rng for the caption choice and the
        crop: (tokens (text_len,) int64, image (size, size, C) float32).  An
        empty caption file or a broken image is reported and skipped to a
        neighbour (a random index when shuffling)."""
        key = self.keys[ind]
        descriptions = [d for d in self.text_files[key].read_text().split("\n") if d]
        if not descriptions:
            print(f"An exception occurred trying to load file {self.text_files[key]}. Skipping index {ind}")
            return self._skip(ind, rng)
        description = rng.choice(descriptions)
        tokens = self.tokenizer.tokenize(description, self.text_len, truncate_text=self.truncate_captions)[0]
        path = self.image_files[key]
        try:
            pixels = decode_image(path.read_bytes(), str(path), self.mode)
        except BrokenImage:
            print(f"An exception occurred trying to load file {path}. Skipping index {ind}")
            return self._skip(ind, rng)
        pixels = random_resized_crop(pixels, self.image_size, rng, scale=(self.resize_ratio, 1.0))
        return tokens, image_to_array(pixels)

    def __getitem__(self, ind: int):
        return self.get(ind, self._rng)


def _item_rng(seed: int, epoch: int, index: int) -> random.Random:
    """The per-sample rng, the same whether samples load serially or on a
    worker pool (int-tuple hashes are stable in CPython)."""
    return random.Random(hash((seed, epoch, int(index))))


def _parallel_map_ordered(fn, items: Iterable, workers: int, lookahead: int) -> Iterator:
    """An ordered map over a thread pool with at most max(lookahead,
    workers) items in flight; serial when workers <= 0."""
    if workers <= 0:
        for x in items:
            yield fn(x)
        return
    with ThreadPoolExecutor(max_workers=workers) as ex:
        dq: collections.deque = collections.deque()
        for x in items:
            dq.append(ex.submit(fn, x))
            while len(dq) >= max(lookahead, workers):
                yield dq.popleft().result()
        while dq:
            yield dq.popleft().result()


def _stack(batch: List[Tuple[np.ndarray, np.ndarray]]) -> dict:
    return {"text": np.stack([t for t, _ in batch]), "image": np.stack([im for _, im in batch])}


def iterate_batches(dataset: TextImageDataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                    process_index: int = 0, process_count: int = 1, drop_last: bool = True,
                    epochs: Optional[int] = 1, num_workers: int = 0, skip_batches: int = 0) -> Iterator[dict]:
    """Batches of the dataset, epoch after epoch: each epoch's order is
    shuffled by `RandomState(seed + epoch)`, then sliced to this process's
    share; a ragged tail is dropped under `drop_last`.  `num_workers` > 0
    decodes on a thread pool, item for item the serial output.
    `skip_batches` starts the first epoch at that batch without decoding
    the ones before it: the resume cursor."""
    n = len(dataset)
    epoch = 0
    skip = max(skip_batches, 0)
    while epochs is None or epoch < epochs:
        order = np.arange(n)
        if shuffle:
            np.random.RandomState(seed + epoch).shuffle(order)
        order = order[process_index::process_count]
        usable = len(order) - (len(order) % batch_size if drop_last else 0)
        order = order[:usable]
        if skip:
            order = order[skip * batch_size:]
            skip = 0
        if not len(order):
            epoch += 1
            continue

        def load(j, e=epoch):
            return dataset.get(int(j), _item_rng(seed, e, int(j)))

        batch: List = []
        for item in _parallel_map_ordered(load, order, num_workers, lookahead=2 * batch_size):
            batch.append(item)
            if len(batch) == batch_size:
                yield _stack(batch)
                batch = []
        if batch and not drop_last:
            yield _stack(batch)
        epoch += 1


# ---------------------------------------------------------------------------
# images alone
# ---------------------------------------------------------------------------


class ImageDataset:
    """A folder of images (searched recursively, in sorted path order), for
    the VAE: each item a random resized square crop, (size, size, C)
    float32 in [0, 1], RGBA when `transparent`."""

    def __init__(self, folder: str, image_size: int, seed: int = 0, transparent: bool = False):
        path = Path(folder)
        self.files = sorted(f for suffix in IMAGE_SUFFIXES for f in path.glob(f"**/*{suffix}"))
        self.image_size = image_size
        self.mode = "RGBA" if transparent else "RGB"
        self._rng = random.Random(seed)
        _refuse_unless_readable(self.files)

    def __len__(self) -> int:
        return len(self.files)

    def get(self, ind: int, rng: random.Random) -> np.ndarray:
        path = self.files[ind]
        pixels = decode_image(path.read_bytes(), str(path), self.mode)
        return image_to_array(random_resized_crop(pixels, self.image_size, rng))

    def __getitem__(self, ind: int) -> np.ndarray:
        return self.get(ind, self._rng)


def iterate_image_batches(dataset: ImageDataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                          process_index: int = 0, process_count: int = 1,
                          num_workers: int = 0) -> Iterator[np.ndarray]:
    """One epoch of (B, H, W, C) batches: the order shuffled by
    `RandomState(seed)`, sliced to this process's share, the ragged tail
    dropped; item j cropped with `_item_rng(seed, 0, j)`.  `num_workers` >
    0 decodes on a thread pool, item for item the serial output."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    order = order[process_index::process_count]
    order = order[: len(order) - len(order) % batch_size]

    def load(j):
        return dataset.get(int(j), _item_rng(seed, 0, int(j)))

    batch: List[np.ndarray] = []
    for item in _parallel_map_ordered(load, order, num_workers, lookahead=2 * batch_size):
        batch.append(item)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []


# ---------------------------------------------------------------------------
# tar shards
# ---------------------------------------------------------------------------


def expand_shard_spec(spec: str) -> List[str]:
    """WebDataset brace expansion: `{000..012}` numeric ranges (the width of
    the left end kept) and `{a,b,c}` lists, any number per spec."""
    m = re.search(r"\{([^{}]*)\}", spec)
    if m is None:
        return [spec]
    head, tail = spec[: m.start()], spec[m.end():]
    body = m.group(1)
    rng = re.fullmatch(r"(\d+)\.\.(\d+)", body)
    if rng:
        lo, hi = rng.group(1), rng.group(2)
        parts = [str(i).zfill(len(lo)) for i in range(int(lo), int(hi) + 1)]
    elif "," in body:
        parts = body.split(",")
    else:
        parts = [body]
    return [e for p in parts for e in expand_shard_spec(head + p + tail)]


def is_remote_shard(shard: str) -> bool:
    return shard.startswith(("http://", "https://", "gs://"))


def refuse_remote_shards(shards: Sequence[str]) -> None:
    remote = [s for s in shards if is_remote_shard(s)]
    if remote:
        raise SystemExit(f"{remote[0]}: remote tar shards are not read; neither machine this port runs on has a "
                         f"network, so only local shards are ({_WAITING})")


def _warn_and_continue(exn: BaseException, name: str) -> None:
    print(f"[tar pipeline] skipping {name}: {exn!r}")


def iterate_tar_shards(shards: Sequence[str], image_size: int, text_len: int, tokenizer, caption_key: str = "txt",
                       image_key: str = "jpg", truncate_captions: bool = True, process_index: int = 0,
                       process_count: int = 1, handler: Callable = _warn_and_continue, seed: int = 0,
                       num_workers: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(tokens, image) pairs from local `.tar` shards, members grouped by
    their stem anywhere in a shard, shards split across processes.  Each
    sample's image is the first of `image_key`, jpg, jpeg, png, bmp that it
    has; a sample without it or without a caption is passed over, an empty
    caption skipped, and a shard or sample that fails to read goes to
    `handler` (warn and continue).  `num_workers` > 0 decodes on a thread
    pool, item for item the serial output.  Remote specs exit by name."""
    refuse_remote_shards(shards)

    def pick_image(members):
        for ext in (image_key, "jpg", "jpeg", "png", "bmp"):
            if ext in members:
                return members[ext]
        return None

    def local_entries(tf, shard) -> Iterator[Tuple[str, bytes, bytes]]:
        samples: dict = {}
        for member in tf.getmembers():
            if not member.isfile():
                continue
            stem, _, ext = member.name.rpartition(".")
            samples.setdefault(stem, {})[ext.lower()] = member
        for stem, members in samples.items():
            img_member = pick_image(members)
            if img_member is None or caption_key not in members:
                continue
            try:
                caption_bytes = tf.extractfile(members[caption_key]).read()
                img_bytes = tf.extractfile(img_member).read()
            except Exception as e:  # noqa: BLE001 — warn and continue, as the JAX loader
                handler(e, f"{shard}:{stem}")
                continue
            yield f"{shard}:{stem}", caption_bytes, img_bytes

    def raw_entries() -> Iterator[Tuple[str, bytes, bytes, int]]:
        counter = 0
        for shard in list(shards)[process_index::process_count]:
            try:
                tf = tarfile.open(shard)
                entries = local_entries(tf, shard)
            except Exception as e:  # noqa: BLE001
                handler(e, shard)
                continue
            try:
                for entry in entries:
                    yield (*entry, counter)
                    counter += 1
            finally:
                tf.close()

    def decode(entry):
        name, caption_bytes, img_bytes, idx = entry
        try:
            caption = caption_bytes.decode("utf-8").strip()
            if not caption:
                return None
            rng = _item_rng(seed, 0, idx)
            pixels = random_resized_crop(decode_image(img_bytes, name, "RGB"), image_size, rng)
            tokens = tokenizer.tokenize(caption, text_len, truncate_text=truncate_captions)[0]
            return tokens, image_to_array(pixels)
        except Exception as e:  # noqa: BLE001 — a SystemExit (no PIL, an unread PNG) passes
            handler(e, name)
            return None

    for item in _parallel_map_ordered(decode, raw_entries(), num_workers, lookahead=64):
        if item is not None:
            yield item


def batch_tar_stream(stream: Iterable, batch_size: int) -> Iterator[dict]:
    """Full batches of a (tokens, image) stream; a ragged tail is dropped."""
    texts: List[np.ndarray] = []
    images: List[np.ndarray] = []
    for tokens, img in stream:
        texts.append(tokens)
        images.append(img)
        if len(texts) == batch_size:
            yield {"text": np.stack(texts), "image": np.stack(images)}
            texts, images = [], []
