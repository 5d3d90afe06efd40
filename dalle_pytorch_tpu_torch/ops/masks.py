"""Static attention-pattern masks (counterpart of
`dalle_pytorch_tpu/ops/masks.py`).

Every sparse attention type is a static boolean mask over one dense
attention, True = may attend, combined with the causal triangle inside the
attention op.  The masks are built in numpy once per configuration; the
flash kernels skip the tiles a mask leaves empty.

Layout: positions 0..text_len-1 are [<bos> + text], positions
text_len..text_len+fmap**2-1 the raster-ordered image grid, where
text_len = seq_len + 1 - fmap**2.  Masks come at (seq_len, seq_len): the
layout cut by its final position.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch.core.device import DeviceLike

ATTN_TYPES = ("full", "axial_row", "axial_col", "conv_like", "sparse")


@lru_cache(maxsize=64)
def _pattern_mask_np(
    attn_type: str,
    seq_len: int,
    image_fmap_size: int,
    kernel_size: int,
    dilation: int,
) -> np.ndarray:
    fmap = image_fmap_size
    img_seq_len = fmap * fmap
    text_len = seq_len + 1 - img_seq_len
    layout = text_len + img_seq_len  # == seq_len + 1

    mask = np.zeros((layout, layout), dtype=bool)
    mask[:, :text_len] = True  # everything attends to text (causality added later)

    if attn_type == "full":
        mask[:, :] = True
    elif attn_type == "axial_row":
        h = np.arange(img_seq_len) // fmap
        mask[text_len:, text_len:] = h[:, None] == h[None, :]
    elif attn_type == "axial_col":
        w = np.arange(img_seq_len) % fmap
        mask[text_len:, text_len:] = w[:, None] == w[None, :]
    elif attn_type == "conv_like":
        h = np.arange(img_seq_len) // fmap
        w = np.arange(img_seq_len) % fmap
        dh = h[:, None] - h[None, :]  # query minus key
        dw = w[:, None] - w[None, :]
        max_off = (kernel_size - 1) * dilation
        ok_h = (dh >= 0) & (dh <= max_off) & (dh % dilation == 0)
        ok_w = (dw >= 0) & (dw <= max_off) & (dw % dilation == 0)
        mask[text_len:, text_len:] = ok_h & ok_w
    else:
        raise ValueError(f'attention type "{attn_type}" has no static mask')

    return mask[:seq_len, :seq_len]


@lru_cache(maxsize=16)
def _block_sparse_mask_np(
    seq_len: int,
    image_fmap_size: int,
    block_size: int,
    num_random_blocks: int,
    local_window_blocks: int,
    seed: int,
) -> np.ndarray:
    """Block-sparse layout with the semantics of DeepSpeed's
    VariableSparsityConfig: fixed block size, a local window of preceding
    blocks, text-covering global blocks (global in both row and column), and
    per-query-block random blocks drawn from `seed`; lower-triangular at
    block granularity."""
    img_seq_len = image_fmap_size ** 2
    text_len = seq_len + 1 - img_seq_len
    nb = -(-seq_len // block_size)
    num_global = -(-text_len // block_size)

    layout = np.zeros((nb, nb), dtype=bool)
    for qb in range(nb):
        lo = max(0, qb - local_window_blocks + 1)
        layout[qb, lo: qb + 1] = True  # local window
    layout[:, :num_global] = True  # global text blocks as keys
    layout[:num_global, :] = True  # global text blocks as queries
    rng = np.random.RandomState(seed)
    for qb in range(nb):
        if qb > 0 and num_random_blocks > 0:
            picks = rng.randint(0, qb + 1, size=num_random_blocks)
            layout[qb, picks] = True
    layout &= np.tril(np.ones((nb, nb), dtype=bool))  # no block above the diagonal

    mask = np.kron(layout, np.ones((block_size, block_size), dtype=bool))
    return mask[:seq_len, :seq_len]


def _block_sparse_mask_np_heads(
    seq_len: int,
    image_fmap_size: int,
    block_size: int,
    num_random_blocks: int,
    local_window_blocks: int,
    seed: int,
    heads: int,
) -> np.ndarray:
    """(heads, seq_len, seq_len): one random-block stream per head, seeded
    `seed + 7919 * head`, as the JAX package draws them (a checkpoint's
    layout depends on it)."""
    return np.stack([
        _block_sparse_mask_np(
            seq_len, image_fmap_size, block_size, num_random_blocks,
            local_window_blocks, seed + 7919 * h,
        )
        for h in range(heads)
    ])


def build_block_sparse_mask(
    seq_len: int,
    image_fmap_size: int,
    block_size: int = 16,
    num_random_blocks: Optional[int] = None,
    local_window_blocks: int = 4,
    seed: int = 0,
    heads: Optional[int] = None,
    device: DeviceLike = "cpu",
) -> torch.Tensor:
    """(seq_len, seq_len) bool layout, or (heads, seq_len, seq_len) when
    `heads` is given: each head draws its own random blocks; the local
    window and the global text blocks are the same for all heads."""
    if num_random_blocks is None:
        num_random_blocks = seq_len // block_size // 4
    if heads is None:
        mask = _block_sparse_mask_np(seq_len, image_fmap_size, block_size, num_random_blocks,
                                     local_window_blocks, seed)
    else:
        mask = _block_sparse_mask_np_heads(seq_len, image_fmap_size, block_size, num_random_blocks,
                                           local_window_blocks, seed, heads)
    return torch.tensor(mask, device=device)  # a copy: the numpy masks are cached


def block_live_np(mask: np.ndarray, block_q: int, block_k: int) -> np.ndarray:
    """Tile liveness of a static pattern mask: (nq, nk) bool, or (h, nq, nk)
    for a per-head mask, True where the (block_q, block_k) tile has at least
    one allowed element.  Any n: the mask is padded with False up to the
    tile grid, nq = ceil(n / block_q), nk = ceil(n / block_k)."""
    m = np.asarray(mask, dtype=bool)
    n = m.shape[-1]
    nq, nk = -(-n // block_q), -(-n // block_k)
    pad = [(0, 0)] * (m.ndim - 2) + [(0, nq * block_q - n), (0, nk * block_k - n)]
    m = np.pad(m, pad)
    if m.ndim == 3:
        return m.reshape(m.shape[0], nq, block_q, nk, block_k).any(axis=(2, 4))
    return m.reshape(nq, block_q, nk, block_k).any(axis=(1, 3))


def build_pattern_mask(
    attn_type: str,
    seq_len: int,
    image_fmap_size: int,
    kernel_size: int = 5,
    dilation: int = 1,
    device: DeviceLike = "cpu",
) -> torch.Tensor:
    """(seq_len, seq_len) bool pattern mask, True = may attend.  The caller
    combines it with the causal triangle."""
    mask = _pattern_mask_np(attn_type, seq_len, image_fmap_size, kernel_size, dilation)
    return torch.tensor(mask, device=device)  # a copy: the numpy masks are cached
