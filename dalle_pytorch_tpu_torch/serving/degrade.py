"""The degrade ladder (counterpart of `dalle_pytorch_tpu/serving/degrade.py`):
under sustained pressure the service gives up declared quality, one rung
at a time, before it sheds.

  rung 0  normal
  rung 1  no_cfg          a guided request is served at cond_scale 1.0: one
                          lane in place of two
  rung 2  cap_candidates  new admissions sample from the capped candidate
                          set (`EngineConfig.degraded_filter_thres`, the
                          lanes' `cand_cap`), and speculation stops
                          (`suppress_spec`)
  rung 3  short_prompts   a prompt of more than `short_prompt_max` tokens
                          is refused (`degraded_long_prompt`)
  rung 4  shed            every new request is refused (`degraded_shed`)

Pressure is a queue fraction at or above `queue_frac_hi` or an open SLO
burn episode; calm is a queue fraction at or below `queue_frac_lo` with no
episode.  A rung is climbed after `enter_after_s` of sustained pressure and
left after `exit_after_s` of sustained calm (hysteresis both ways), and
each request is stamped with the rung it was admitted under.  The engine
shapes each submit (`shape_request`); the engine, or the fleet across its
replicas, observes the pressure once a poll.  Host bookkeeping only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np

from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.serving.scheduler import AdmissionRefused

RUNGS = ("normal", "no_cfg", "cap_candidates", "short_prompts", "shed")


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """The thresholds and the two timers of the hysteresis."""

    enter_after_s: float = 0.5
    exit_after_s: float = 2.0
    queue_frac_hi: float = 0.75
    queue_frac_lo: float = 0.25
    short_prompt_max: Optional[int] = None  # default text_seq_len // 2
    max_rung: int = len(RUNGS) - 1


class DegradeLadder:
    """One ladder for every engine of a deployment."""

    def __init__(self, cfg: DegradeConfig = DegradeConfig(), text_seq_len: int = 256, on_alarm=None):
        self.cfg = cfg
        self.short_prompt_max = (cfg.short_prompt_max if cfg.short_prompt_max is not None
                                 else max(text_seq_len // 2, 1))
        self.on_alarm = on_alarm
        self.rung = 0
        self.max_rung_seen = 0
        self.rungs_entered: Dict[str, int] = {}
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        obs_metrics.gauge("serving/degrade_rung").set(0)

    @property
    def rung_name(self) -> str:
        return RUNGS[self.rung]

    @property
    def suppress_spec(self) -> bool:
        """From cap_candidates up the engine runs the sequential step in
        place of a speculative round (both read the same lane state)."""
        return self.rung >= 2

    def observe(self, queue_frac: float, slo=None, now: Optional[float] = None) -> int:
        """One pressure sample; returns the rung."""
        now = time.monotonic() if now is None else now
        burning = bool(getattr(slo, "_alarmed", None))  # an SLO episode is open
        pressure = queue_frac >= self.cfg.queue_frac_hi or burning
        calm = queue_frac <= self.cfg.queue_frac_lo and not burning
        if pressure:
            self._calm_since = None
            if self._pressure_since is None:
                self._pressure_since = now
            elif now - self._pressure_since >= self.cfg.enter_after_s and self.rung < self.cfg.max_rung:
                self._set_rung(self.rung + 1, queue_frac, burning)
                self._pressure_since = now  # one rung a sustained window
        elif calm:
            self._pressure_since = None
            if self._calm_since is None:
                self._calm_since = now
            elif now - self._calm_since >= self.cfg.exit_after_s and self.rung > 0:
                self._set_rung(self.rung - 1, queue_frac, burning)
                self._calm_since = now
        else:  # between the thresholds neither timer runs
            self._pressure_since = None
            self._calm_since = None
        return self.rung

    def _set_rung(self, rung: int, queue_frac: float, burning: bool) -> None:
        prev = self.rung
        self.rung = rung
        self.max_rung_seen = max(self.max_rung_seen, rung)
        if rung > prev:
            self.rungs_entered[RUNGS[rung]] = self.rungs_entered.get(RUNGS[rung], 0) + 1
            obs_metrics.counter("serving/degrade_climbs").inc()
        else:
            obs_metrics.counter("serving/degrade_descents").inc()
        obs_metrics.gauge("serving/degrade_rung").set(rung)
        if self.on_alarm is not None and rung > prev:
            self.on_alarm({"type": "degrade_rung", "rung": rung, "name": RUNGS[rung], "from": prev,
                           "queue_frac": round(queue_frac, 4), "slo_burning": burning})

    def shape_request(self, req) -> None:
        """Apply the rung to a new request in place, before admission's
        screen: raises AdmissionRefused at the refusing rungs, serves a
        guided request unguided from no_cfg up, and stamps the rung."""
        req.degrade_rung = self.rung
        if self.rung >= 4:
            raise AdmissionRefused("degradation ladder at rung shed: refusing all new requests",
                                   kind="degraded_shed")
        if self.rung >= 3:
            n_tok = int((np.asarray(req.text) != 0).sum())
            if n_tok > self.short_prompt_max:
                raise AdmissionRefused(f"degradation ladder at rung short_prompts: prompt has {n_tok} tokens > "
                                       f"{self.short_prompt_max}", kind="degraded_long_prompt")
        if self.rung >= 1 and req.cond_scale != 1.0:
            req.cond_scale = 1.0
            obs_metrics.counter("serving/degrade_cfg_disabled").inc()

    def state(self) -> Dict[str, Any]:
        return {"rung": self.rung, "name": self.rung_name, "max_rung_seen": self.max_rung_seen,
                "rungs_entered": dict(self.rungs_entered)}
