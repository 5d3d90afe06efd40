"""The engine's per-lane sampler (counterpart of the part of
`dalle_pytorch_tpu/models/speculative.py` `lane_sample_pipeline` that the
sequential engine runs): transformer output -> one image code per lane.

Every lane is one sequence of one request; a guided request holds two, its
[cond] lane and its [null] lane.  Per lane: the masked image logits at the
lane's producing position, classifier-free guidance across the lane pair
(`partner`, `guided`, `cscale`), top-k at `filter_thres`, the lane's
temperature, the lane's gumbel noise, the shift into the codebook, and the
feed-source mirror (`feed_src`), so that both lanes of a pair feed the
[cond] lane's code.  Each lane's noise comes from the lane's own generator,
one (1, total_tokens) draw a token, as a batch-1 `sample_image_codes` draws
it; or, for a lane whose request brought its noise (`use_noise`), from its
row of `noise` at the index of the code being made.

In a decode step two more things happen, between the guidance and the
top-k: poison injection (the lane `poison_lane` names, -1 for none, gets
NaN logits before the guidance: the fault drill of `--inject_fault
poison-request`) and the nonfinite screen (a live lane whose guided logits
hold a NaN or an infinity is flagged `bad`, and its logits are set to 0 so
that it samples something finite).  The engine accumulates the flags and
quarantines the request at its eviction.  The degrade cap: a lane whose
`cand_cap` is set (a request admitted at the degrade ladder's
cap_candidates rung or above) keeps only the first max(int((1 -
degraded_filter_thres) V), 1) of its top-k candidates, chosen per lane by
`torch.where`, so the captured step has no host branch.

`LaneState` holds these per-lane tensors on the device; they are written
in place at admission, so a captured step reads their new values.  Under
speculative decoding every lane reads its noise from the table: at
admission the request's generator fills its rows in the order a batch-1
loop draws them (`fill_noise`), so that the rounds read a position's row
whatever order they take the positions in.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise, top_k_filter


class LaneState:
    """Per-lane sampling state of `num_lanes` lanes on `device`.  `noise`
    (num_lanes, n_rows, total_tokens) exists only with `noise_rows`."""

    def __init__(self, num_lanes: int, total_tokens: int, device: torch.device, noise_rows: int = 0):
        self.temp = torch.ones(num_lanes, device=device)
        self.cscale = torch.ones(num_lanes, device=device)
        self.guided = torch.zeros(num_lanes, dtype=torch.bool, device=device)
        self.partner = torch.arange(num_lanes, device=device)
        self.feed_src = torch.arange(num_lanes, device=device)
        self.use_noise = torch.zeros(num_lanes, dtype=torch.bool, device=device)
        self.cand_cap = torch.zeros(num_lanes, dtype=torch.bool, device=device)
        self.noise = (torch.zeros((num_lanes, noise_rows, total_tokens), device=device) if noise_rows else None)
        self.generators: List[torch.Generator] = [torch.Generator(device=device) for _ in range(num_lanes)]
        self.total_tokens = total_tokens
        self.poison_lane = torch.full((), -1, dtype=torch.long, device=device)

    def arm(self, lanes: List[int], temperature: float, cond_scale: float, seed: int,
            noise: Optional[torch.Tensor], cap: bool = False, rng_state: Optional[torch.Tensor] = None) -> None:
        """Set a request's lanes: its sampling settings, the degrade cap,
        the pair's partner and feed source, and its randomness (each lane's
        generator at `rng_state`, or seeded with `seed` as a fresh
        `torch.Generator(device).manual_seed(seed)` is; the noise rows
        copied in)."""
        device = self.temp.device
        idx = torch.tensor(lanes, device=device)
        self.temp[idx] = temperature
        self.cscale[idx] = cond_scale
        self.cand_cap[idx] = cap
        cond, null = lanes[0], lanes[-1]  # one lane: its own partner
        self.guided[idx] = False
        self.guided[cond] = len(lanes) == 2
        self.partner[idx] = null
        self.feed_src[idx] = cond
        state = torch.Generator(device=device).manual_seed(seed).get_state() if rng_state is None else rng_state
        for lane in lanes:
            self.generators[lane].set_state(state)
        self.use_noise[idx] = noise is not None
        if noise is not None:
            self.noise[cond].copy_(noise)

    def fill_noise(self, lane: int, seed: int) -> None:
        """Fill `lane`'s noise rows from a generator seeded with `seed`, one
        (1, total_tokens) draw a row, as a batch-1 loop draws a token's
        noise, and make the lane read them."""
        gen = torch.Generator(device=self.temp.device).manual_seed(seed)
        for row in range(self.noise.shape[1]):
            self.noise[lane, row] = gumbel_noise((1, self.total_tokens), gen, self.noise.dtype, self.noise.device)[0]
        self.use_noise[lane] = True

    def table_rows(self, rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Every lane's noise row `rows[i]` (L, total_tokens), from the table
        alone."""
        table = self.noise
        at = rows.clamp(0, table.shape[1] - 1)
        return table[torch.arange(table.shape[0], device=table.device), at].to(dtype)

    def draw(self, lanes: Optional[List[int]], rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Gumbel noise (L, total_tokens) for `lanes` (all of them when
        None): one (1, total_tokens) draw from each lane's generator, or the
        lane's noise row `rows[i]` where its request brought noise."""
        device = self.temp.device
        order = range(len(self.generators)) if lanes is None else lanes
        noise = torch.cat([gumbel_noise((1, self.total_tokens), self.generators[lane], dtype, device)
                           for lane in order])
        if self.noise is None:
            return noise
        use, table = self.use_noise, self.noise
        if lanes is not None:
            idx = torch.tensor(lanes, device=device)
            use, table = use[idx], table[idx]
        staged = table[torch.arange(table.shape[0], device=device), rows.clamp(0, table.shape[1] - 1)]
        return torch.where(use[:, None], staged, noise)

    def settings(self, lanes: Optional[List[int]] = None):
        """(temp, cscale, guided, partner, feed_src) of all lanes, or of one
        request's `lanes` ([cond] or [cond, null]) with the pair's partner
        and feed source as indices within them."""
        if lanes is None:
            return self.temp, self.cscale, self.guided, self.partner, self.feed_src
        idx = torch.tensor(lanes, device=self.temp.device)
        partner = torch.full_like(idx, len(lanes) - 1)
        return self.temp[idx], self.cscale[idx], self.guided[idx], partner, torch.zeros_like(idx)


def request_settings(n_lanes: int, temperature: float, cond_scale: float, device):
    """One request's lane settings, as `LaneState.settings(lanes)` gives
    them once its lanes are armed: what a prefill worker samples the first
    code with, away from any engine's lanes."""
    idx = torch.arange(n_lanes, device=device)
    temp = torch.full((n_lanes,), float(temperature), device=device)
    cscale = torch.full((n_lanes,), float(cond_scale), device=device)
    return temp, cscale, (idx == 0) & (n_lanes == 2), torch.full_like(idx, n_lanes - 1), torch.zeros_like(idx)


def capped_top_k(logits: torch.Tensor, filter_thres: float, cand_cap: Optional[torch.Tensor] = None,
                 degraded_filter_thres: float = 0.98) -> torch.Tensor:
    """`top_k_filter` at `filter_thres`, with a `cand_cap` lane keeping only
    the first max(int((1 - degraded_filter_thres) V), 1) of its top k (at
    most k): the JAX pipeline's `k_cap`."""
    if cand_cap is None:
        return top_k_filter(logits, thres=filter_thres)
    v = logits.shape[-1]
    k = max(int((1.0 - filter_thres) * v), 1)
    k_cap = min(max(int((1.0 - degraded_filter_thres) * v), 1), k)
    val, ind = torch.topk(logits, k, dim=-1)
    drop = cand_cap[:, None] & (torch.arange(k, device=logits.device) >= k_cap)
    return torch.full_like(logits, float("-inf")).scatter(-1, ind, val.masked_fill(drop, float("-inf")))


def sample_lanes(model: DALLE, logits: torch.Tensor, settings, filter_thres: float, noise: torch.Tensor,
                 active: Optional[torch.Tensor] = None, poison_lane: Optional[torch.Tensor] = None,
                 cand_cap: Optional[torch.Tensor] = None,
                 degraded_filter_thres: float = 0.98) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(codes (L,), bad (L,) or None) from the masked image logits (L,
    total_tokens) of L lanes with their `LaneState.settings`: poison
    injection at `poison_lane`, guidance across partners, the nonfinite
    screen of the `active` lanes (none without `active`: the admission's
    first code), top-k (capped on the `cand_cap` lanes), temperature,
    noise, the shift into the codebook and the feed-source mirror."""
    cfg = model.cfg
    temp, cscale, guided, partner, feed_src = settings
    if poison_lane is not None:
        inject = torch.arange(logits.shape[0], device=logits.device) == poison_lane
        logits = logits.masked_fill(inject[:, None], float("nan"))
    null = logits.index_select(0, partner)
    lg = torch.where(guided[:, None], null + (logits - null) * cscale[:, None], logits)
    bad = None
    if active is not None:
        bad = ~torch.isfinite(lg).all(dim=-1) & active
        lg = lg.masked_fill(bad[:, None], 0.0)
    filtered = capped_top_k(lg, filter_thres, cand_cap, degraded_filter_thres)
    scaled = filtered / temp[:, None]
    tok = torch.argmax(scaled + noise, dim=-1)
    code = (tok - cfg.num_text_tokens_padded).clamp(0, cfg.num_image_tokens - 1)
    return code.index_select(0, feed_src), bad
