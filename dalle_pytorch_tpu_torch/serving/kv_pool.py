"""The paged KV block pool's host half (counterpart of
`dalle_pytorch_tpu/serving/kv_pool.py`): which physical blocks are free,
which belong to which lane of which request, and the occupancy numbers
that admission control prices against.  The device half (the pool tensors,
the gather and the column writes through block tables) is
`models/paged.py`.

Allocation is whole-sequence at admission: a request's length is fixed
(text + image_seq_len), so a reservation and an allocation are one thing,
and refusing up front turns an exhausted pool into backpressure instead of
an out-of-memory error.  Block 0 is the trash block inactive slots write
into; it is never handed out.  The block ids, and the order in which they
are handed out and returned, are the JAX package's.

The flight recorder: with a `PoolFlightRecorder` attached (`pool.recorder`)
every alloc_table, free_table and truncate_slot leaves one event (owner,
blocks, occupancy and high water then, a monotonic time) in a bounded ring;
without one the hooks are one `is None` test.  Its flush into telemetry
spans comes with ROADMAP.md Queue 1 item 8; its live gauges
(`observability/pool.PoolGauges`) read each event as it is recorded.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models.paged import init_paged_pool, paged_blocks_per_seq
from dalle_pytorch_tpu_torch.models.transformer import TransformerConfig
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.quantization import kv_bytes_per_elem


class PoolExhausted(RuntimeError):
    """No free blocks for a whole-sequence allocation."""


class PoolFlightRecorder:
    """A ring of the last `capacity` block events; an event past it drops
    the oldest, counted in `dropped`.  `ctx` is the admission's context
    (request, journey, lanes, guidance, prompt hash) stamped on its lanes'
    allocs; `on_event` sees every event as it is recorded."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._ring: Deque[Dict[str, Any]] = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.ctx: Optional[Dict[str, Any]] = None
        self.on_event: Optional[Callable[[Dict[str, Any]], None]] = None

    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> List[Dict[str, Any]]:
        """The ring's events, oldest first."""
        return list(self._ring)

    def record(self, op: str, **fields) -> None:
        ev = {"op": op, "mono": time.monotonic(), **fields}
        if len(self._ring) == self.capacity:
            self.dropped += 1  # the deque drops the oldest
        self._ring.append(ev)
        if self.on_event is not None:
            self.on_event(ev)


@dataclasses.dataclass
class BlockPool:
    """Host free list over the shared device pool.  `num_blocks` counts
    usable blocks (the trash block comes on top), `block_size` tokens a
    block."""

    cfg: TransformerConfig
    num_blocks: int
    block_size: int
    dtype: torch.dtype = torch.float32
    quant: Optional[str] = None  # "int8": int8 blocks with per-token bf16 scales

    def __post_init__(self):
        if self.block_size <= 0 or self.num_blocks <= 0:
            raise ValueError(f"block_size and num_blocks must be positive, got {self.block_size}, "
                             f"{self.num_blocks}")
        if self.quant == "none":
            self.quant = None
        kv_bytes_per_elem(self.quant, 1, self.cfg.dim_head)  # an unknown kind raises
        self.blocks_per_seq = paged_blocks_per_seq(self.cfg, self.block_size)
        # physical ids 1..num_blocks; 0 is the trash block
        self._free: List[int] = list(range(1, self.num_blocks + 1))
        self._owned: Dict[int, List[int]] = {}
        self._high_water = 0
        self.recorder: Optional[PoolFlightRecorder] = None

    def device_pool(self, device=None) -> dict:
        """Zeroed device tensors for this geometry, the trash block
        included."""
        return init_paged_pool(self.cfg, self.num_blocks + 1, self.block_size, self.dtype, device, self.quant)

    def bytes(self, itemsize: Optional[int] = None) -> float:
        """At-rest bytes of the device pool (k and v, every layer, the trash
        block included), priced by `kv_bytes_per_elem`: an int8 pool at 1 +
        2 / dim_head bytes an element."""
        if itemsize is None:
            itemsize = torch.empty((), dtype=self.dtype).element_size()
        cfg = self.cfg
        per_elem = kv_bytes_per_elem(self.quant, itemsize, cfg.dim_head)
        return 2.0 * cfg.depth * (self.num_blocks + 1) * cfg.heads * self.block_size * cfg.dim_head * per_elem

    def prefix_bytes(self, n_tokens: int, itemsize: Optional[int] = None) -> float:
        """At-rest KV bytes of one lane's `n_tokens`-long prefix in this
        pool (k and v, every layer), priced as `bytes` prices a block."""
        if itemsize is None:
            itemsize = torch.empty((), dtype=self.dtype).element_size()
        cfg = self.cfg
        return 2.0 * cfg.depth * cfg.heads * n_tokens * cfg.dim_head * kv_bytes_per_elem(self.quant, itemsize,
                                                                                         cfg.dim_head)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def occupancy_frac(self) -> float:
        return self.used_blocks / self.num_blocks

    @property
    def high_water(self) -> int:
        """Most blocks ever in use at once."""
        return self._high_water

    @property
    def fragmentation_frac(self) -> float:
        """1 - (largest contiguous free run / free blocks)."""
        if not self._free:
            return 0.0
        ids = sorted(self._free)
        best = run = 1
        for a, b in zip(ids, ids[1:]):
            run = run + 1 if b == a + 1 else 1
            best = max(best, run)
        return 1.0 - best / len(self._free)

    def can_admit(self) -> bool:
        return len(self._free) >= self.blocks_per_seq

    def fits_ever(self) -> bool:
        """Whether one sequence fits the pool at all, even when idle."""
        return self.num_blocks >= self.blocks_per_seq

    def alloc_table(self, owner: int) -> np.ndarray:
        """A full sequence's blocks for `owner`: the (blocks_per_seq,) int64
        block table.  Raises PoolExhausted when they are not free."""
        if len(self._free) < self.blocks_per_seq:
            raise PoolExhausted(f"need {self.blocks_per_seq} blocks, {len(self._free)} free")
        blocks = [self._free.pop() for _ in range(self.blocks_per_seq)]
        self._owned[owner] = blocks
        self._high_water = max(self._high_water, self.used_blocks)
        rec = self.recorder
        if rec is not None:
            rec.record("alloc", owner=owner, blocks=list(blocks), reserved=len(blocks), occupancy=self.used_blocks,
                       high_water=self._high_water, free=len(self._free), **(rec.ctx or {}))
        self.publish_gauges()
        return np.asarray(blocks, np.int64)

    def free_table(self, owner: int, written_tokens: Optional[int] = None) -> None:
        """Return `owner`'s blocks to the free list (eviction).
        `written_tokens`: the KV tokens the lane wrote, for the recorder's
        reserved-but-unused count."""
        blocks = self._owned.pop(owner, None)
        if blocks:
            self._free.extend(blocks)
            rec = self.recorder
            if rec is not None:
                rec.record("free", owner=owner, released=len(blocks), written=written_tokens,
                           occupancy=self.used_blocks, high_water=self._high_water, free=len(self._free))
            self.publish_gauges()

    def truncate_slot(self, owner: int, n: int) -> int:
        """Roll `owner`'s sequence back to `n` valid tokens (a speculative
        round rejected what lies past them).  The reservation keeps its
        blocks: this is the host's commit point, recorded, and it returns
        the blocks holding live tokens."""
        if owner not in self._owned:
            raise KeyError(f"truncate_slot: owner {owner} holds no blocks")
        if not 0 <= n <= self.blocks_per_seq * self.block_size:
            raise ValueError(f"truncate_slot: n={n} outside [0, {self.blocks_per_seq * self.block_size}]")
        live = -(-n // self.block_size)
        rec = self.recorder
        if rec is not None:
            rec.record("truncate", owner=owner, tokens=n, live_blocks=live, occupancy=self.used_blocks,
                       free=len(self._free))
        self.publish_gauges()
        return live

    def publish_gauges(self) -> None:
        """The free list's state in the metrics registry."""
        obs_metrics.gauge("serving/pool_blocks_free").set(self.free_blocks)
        obs_metrics.gauge("serving/pool_high_water").set(self._high_water)

    def owners(self) -> List[int]:
        return list(self._owned)

    def summary(self) -> dict:
        """The free-list state the serve report carries."""
        return {"num_blocks": self.num_blocks, "block_size": self.block_size,
                "blocks_per_seq": self.blocks_per_seq, "occupancy_frac": round(self.occupancy_frac, 4),
                "free_blocks": self.free_blocks, "high_water": self.high_water,
                "fragmentation_frac": round(self.fragmentation_frac, 4), "bytes": self.bytes(),
                "kv_dtype": self.quant or str(self.dtype).replace("torch.", "")}


def blocks_within_bytes(cfg: TransformerConfig, budget_bytes: float, block_size: int, itemsize: int = 2,
                        kv_quant: Optional[str] = None) -> int:
    """How many usable blocks fit an at-rest byte budget, the trash block's
    cost included; a quantized pool (`kv_quant`) holds more of them."""
    per_block = (2.0 * cfg.depth * cfg.heads * block_size * cfg.dim_head
                 * kv_bytes_per_elem(kv_quant, itemsize, cfg.dim_head))
    return max(int(budget_bytes // per_block) - 1, 0)
