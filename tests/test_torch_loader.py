"""The port's data layer (`data/loader.py`, `cli/png.py`) against the JAX
package's loader and PIL, on the CPU.

- The PNG reader gives PIL's arrays bit for bit: files PIL writes with its
  adaptive filters in every mode the reader takes (grey, grey + alpha,
  RGB, RGBA, palette, with and without tRNS, 1-bit), and files whose rows
  cycle through all five filters over several IDAT chunks.  16-bit and
  interlaced files are refused by name.
- `random_resized_crop` equals the JAX one's array exactly (PIL's bilinear
  resize with a box), over many sizes, boxes and seeds, RGB and RGBA.
- `TextImageDataset` items and `iterate_batches` batches equal the JAX
  loader's, serial and on two workers, with `skip_batches`; the tar
  pipeline's batches equal the JAX one's on a shard the test writes.
- A remote shard spec, and a JPEG with PIL hidden, are refused by name."""
import io
import random
import struct
import sys
import tarfile
import zlib

import numpy as np
import pytest

from dalle_pytorch_tpu_torch.cli import png
from dalle_pytorch_tpu_torch.data import loader as tl
from dalle_pytorch_tpu_torch.data.tokenizer import SimpleTokenizer
from torch_data_refs import write_pairs, write_shard

Image = pytest.importorskip("PIL.Image")
jl = pytest.importorskip("dalle_pytorch_tpu.data.loader")


@pytest.fixture(scope="module")
def tokenizers():
    """The JAX tokenizer in pure Python: its C++ merge engine, once
    `native/_libbpe.so` is built, writes every word into one shared ctypes
    buffer, and the loader's worker threads then read one another's ids."""
    from dalle_pytorch_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer

    return JaxTokenizer(use_native=False), SimpleTokenizer()


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


def _pixels(rng, h, w, c, smooth):
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w]
        base = (xx * 5 + yy * 3) % 256
        return np.stack([(base * (k + 1) + k * 40) % 256 for k in range(c)], -1).astype(np.uint8)
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


def _filter_types(data):
    """The filter byte of every row of a PNG's image data."""
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        header = struct.unpack(">IIBBBBB", body) if tag == b"IHDR" else header
        idat += [body] if tag == b"IDAT" else []
        pos += 12 + length
    w, h, depth, color = header[:4]
    stride = (w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth + 7) // 8
    return set(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)[:, 0].tolist())


def _pil_files():
    rng = np.random.default_rng(0)
    for smooth in (True, False):
        rgba = _pixels(rng, 37, 45, 4, smooth)
        images = {"L": Image.fromarray(rgba[..., 0], "L"), "LA": Image.fromarray(rgba[..., :2], "LA"),
                  "RGB": Image.fromarray(rgba[..., :3], "RGB"), "RGBA": Image.fromarray(rgba, "RGBA"),
                  "P": Image.fromarray(rgba[..., :3], "RGB").quantize(colors=50),
                  "P4": Image.fromarray(rgba[..., :3], "RGB").quantize(colors=12),
                  "1": Image.fromarray(rgba[..., 0], "L").convert("1")}
        for name, img in images.items():
            yield f"{name}-{smooth}", _pil_bytes(img)
        yield f"P-trns-{smooth}", _pil_bytes(images["P"], transparency=3)
        yield f"L-trns-{smooth}", _pil_bytes(images["L"], transparency=7)
        yield f"RGB-trns-{smooth}", _pil_bytes(images["RGB"], transparency=tuple(int(v) for v in rgba[0, 0, :3]))


def test_png_reader_equals_pil_on_files_pil_writes():
    seen = set()
    for name, data in _pil_files():
        seen |= _filter_types(data)
        decoded = png.decode_png(data, name)
        ref = Image.open(io.BytesIO(data))
        assert decoded.mode == ref.mode or (decoded.mode, ref.mode) == ("L", "1"), name
        for mode in ("RGB", "RGBA"):
            np.testing.assert_array_equal(png.convert(decoded, mode), np.asarray(ref.convert(mode)), err_msg=name)
    assert {0, 1, 2, 4} <= seen  # PIL's adaptive filter used None, Sub, Up and Paeth


def _encode_filtered(pixels: np.ndarray, colour: int, n_idat: int) -> bytes:
    """A PNG whose row y uses filter y % 5, its zlib stream split over
    n_idat IDAT chunks."""
    h, w, c = pixels.shape
    rows, prior = [], np.zeros(w * c, np.int64)
    for y in range(h):
        line = pixels[y].reshape(-1).astype(np.int64)
        kind = y % 5
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([kind]) + ((line - pred) % 256).astype(np.uint8).tobytes())
        prior = line
    stream = zlib.compress(b"".join(rows))
    cut = np.linspace(0, len(stream), n_idat + 1).astype(int)
    chunks = [png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))]
    chunks += [png._chunk(b"IDAT", stream[a:b]) for a, b in zip(cut[:-1], cut[1:])]
    return png._SIGNATURE + b"".join(chunks) + png._chunk(b"IEND", b"")


@pytest.mark.parametrize("colour,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_every_filter_over_several_idat_chunks(colour, channels):
    pixels = np.random.default_rng(colour).integers(0, 256, (23, 17, channels), dtype=np.uint8)
    data = _encode_filtered(pixels, colour, n_idat=4)
    assert _filter_types(data) == {0, 1, 2, 3, 4}
    decoded = png.decode_png(data)
    np.testing.assert_array_equal(decoded.samples, pixels)
    ref = Image.open(io.BytesIO(data))
    for mode in ("RGB", "RGBA"):
        np.testing.assert_array_equal(png.convert(decoded, mode), np.asarray(ref.convert(mode)))


def _header_only(w, h, depth, colour, interlace):
    """A PNG of one grey row pattern with the given IHDR fields."""
    rows = b"".join(b"\x00" + bytes(w * depth // 8) for _ in range(h))
    return (png._SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
            + png._chunk(b"IDAT", zlib.compress(rows)) + png._chunk(b"IEND", b""))


def test_sixteen_bit_and_interlaced_are_refused_by_name(tmp_path):
    deep, laced = tmp_path / "deep.png", tmp_path / "laced.png"
    deep.write_bytes(_header_only(8, 8, 16, 0, 0))
    laced.write_bytes(_header_only(8, 8, 8, 0, 1))
    assert Image.open(deep).size == (8, 8) and Image.open(laced).size == (8, 8)  # valid files: PIL opens both
    for path, cause in ((deep, "16-bit"), (laced, "interlaced")):
        with pytest.raises(png.PngUnsupported, match=cause) as err:
            png.read_png(path)
        assert str(path) in str(err.value)
        with pytest.raises(SystemExit, match=cause):
            tl.decode_image(path.read_bytes(), str(path), "RGB")


def test_random_resized_crop_equals_jax_exactly():
    rng = np.random.default_rng(1)
    for trial in range(120):
        h, w = int(rng.integers(6, 80)), int(rng.integers(6, 80))
        size = int(rng.integers(3, 70))
        mode = "RGBA" if trial % 4 == 0 else "RGB"
        pixels = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
        if mode == "RGBA":
            pixels[..., 3] = rng.choice([0, 1, 90, 200, 255], (h, w))
        seed, lo = int(rng.integers(1 << 30)), float(rng.uniform(0.05, 1.0))
        ref = jl.random_resized_crop(Image.fromarray(pixels, mode), size, random.Random(seed), scale=(lo, 1.0))
        got = tl.random_resized_crop(pixels, size, random.Random(seed), scale=(lo, 1.0))
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=f"{h}x{w} -> {size} {mode}")


def test_resize_matches_pil_on_every_box_kind():
    """Up- and downscales, boxes at the edges, fractional and whole
    factors, and a box that keeps one axis (PIL skips that pass)."""
    pixels = np.random.default_rng(2).integers(0, 256, (50, 64, 3), dtype=np.uint8)
    img = Image.fromarray(pixels, "RGB")
    for size, box in (((16, 16), (0, 0, 64, 50)), ((64, 50), (0, 0, 64, 50)), ((64, 20), (0, 3, 64, 40)),
                      ((7, 50), (5, 0, 60, 50)), ((100, 90), (10, 10, 30, 25)), ((33, 33), (31, 17, 64, 50))):
        np.testing.assert_array_equal(tl.resize_bilinear(pixels, size, box),
                                      np.asarray(img.resize(size, Image.BILINEAR, box=box)))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    (root / "broken.png").write_bytes(png._SIGNATURE + b"\x00\x00\x00\x0dIHDR" + bytes(9))
    (root / "broken.txt").write_text("a broken image")
    write_pairs(root, 14, seed=3)
    return root


def _datasets(folder, tokenizers, **kw):
    jtok, ttok = tokenizers
    kw = dict(dict(text_len=12, image_size=24, truncate_captions=True, shuffle=True), **kw)
    return jl.TextImageDataset(str(folder), tokenizer=jtok, **kw), tl.TextImageDataset(str(folder), tokenizer=ttok,
                                                                                       **kw)


def _equal_batches(got, ref):
    assert len(got) == len(ref) and len(ref) > 0
    for g, r in zip(got, ref):
        for key in ("text", "image"):
            assert g[key].dtype == r[key].dtype and g[key].shape == r[key].shape
            np.testing.assert_array_equal(g[key], r[key])


def test_dataset_items_equal_jax(folder, tokenizers, capsys):
    """Every index, the broken image and the empty caption file included
    (both skipped to another sample, the same one)."""
    jds, tds = _datasets(folder, tokenizers, resize_ratio=0.6)
    assert tds.keys == jds.keys and len(tds) == 15
    for i in range(len(tds)):
        (jt, ji), (tt, ti) = jds.get(i, random.Random(i)), tds.get(i, random.Random(i))
        assert tt.dtype == jt.dtype and ti.dtype == ji.dtype
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(ti, ji)
    out = capsys.readouterr().out
    assert "broken.png. Skipping" in out and "img003.txt. Skipping" in out


@pytest.mark.parametrize("workers,skip", [(0, 0), (2, 0), (2, 2)])
def test_batches_equal_jax(folder, tokenizers, workers, skip):
    jds, tds = _datasets(folder, tokenizers)
    kw = dict(batch_size=3, seed=7, epochs=2, num_workers=workers, skip_batches=skip)
    _equal_batches(list(tl.iterate_batches(tds, **kw)), list(jl.iterate_batches(jds, **kw)))
    if workers:  # the pool gives the serial path's batches
        serial = list(tl.iterate_batches(tds, **dict(kw, num_workers=0)))
        _equal_batches(list(tl.iterate_batches(tds, **kw)), serial)


def test_process_slicing_and_ragged_tail_equal_jax(folder, tokenizers):
    jds, tds = _datasets(folder, tokenizers)
    for kw in (dict(process_index=1, process_count=2), dict(drop_last=False, shuffle=False)):
        kw = dict(dict(batch_size=4, seed=1), **kw)
        _equal_batches(list(tl.iterate_batches(tds, **kw)), list(jl.iterate_batches(jds, **kw)))


def test_tar_batches_equal_jax(folder, tokenizers, tmp_path, capsys):
    shards = [str(tmp_path / "a.tar"), str(tmp_path / "b.tar")]
    write_shard(shards[0], folder)
    write_shard(shards[1], folder / "nested")
    jtok, ttok = tokenizers
    kw = dict(image_size=20, text_len=10, seed=5)
    for workers in (0, 2):
        ref = list(jl.batch_tar_stream(jl.iterate_tar_shards(shards, tokenizer=jtok, num_workers=workers, **kw), 4))
        got = list(tl.batch_tar_stream(tl.iterate_tar_shards(shards, tokenizer=ttok, num_workers=workers, **kw), 4))
        _equal_batches(got, ref)
    assert "skipping" in capsys.readouterr().out  # the broken image, reported


def test_remote_shards_are_refused_by_name(tokenizers):
    spec = "https://host/shard-{000..002}.tar"
    assert tl.expand_shard_spec(spec) == jl.expand_shard_spec(spec)
    assert tl.expand_shard_spec("s-{a,b}-{1..2}.tar") == jl.expand_shard_spec("s-{a,b}-{1..2}.tar")
    with pytest.raises(SystemExit, match="remote tar shards.*item 10") as err:
        list(tl.iterate_tar_shards(tl.expand_shard_spec(spec), 16, 8, tokenizers[1]))
    assert "https://host/shard-000.tar" in str(err.value)


def test_jpeg_without_pil_is_refused_by_name(folder, tokenizers, tmp_path, monkeypatch):
    """PIL hidden: a folder holding a JPEG exits naming it, PNGs still
    decode, and a JPEG in a shard exits rather than being skipped."""
    jpeg = sorted(folder.rglob("*.jpg"))[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tl._pil_image() is None
    with pytest.raises(SystemExit, match="needs PIL.*item 10") as err:
        tl.TextImageDataset(str(folder), tokenizer=tokenizers[1])
    assert jpeg.name in str(err.value)
    png_file = folder / "img000.png"
    assert tl.decode_image(png_file.read_bytes(), str(png_file), "RGB").shape[-1] == 3
    shard = tmp_path / "j.tar"
    with tarfile.open(shard, "w") as tf:
        tf.add(jpeg, arcname="x.jpg")
        tf.add(jpeg.with_suffix(".txt"), arcname="x.txt")
    with pytest.raises(SystemExit, match="j.tar:x: decoding JPEG or BMP needs PIL"):
        list(tl.iterate_tar_shards([str(shard)], 16, 8, tokenizers[1]))
