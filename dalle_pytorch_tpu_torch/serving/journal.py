"""The request journal (counterpart of `dalle_pytorch_tpu/serving/journal.py`):
an append-only JSONL log, fsynced, so that a crash of the whole process
cannot lose an accepted request.

Three kinds of record:
- `accepted`: what replays the request (text ids, seed, temperature,
  cond_scale, deadline and retry budget), fsynced before submit returns;
- `progress`: every `progress_every` codes, `codes_done`, the request's
  position in its randomness (the engine's host counter; no device sync);
- `ack`: the terminal outcome (completed, shed, poisoned,
  requeue_exhausted).  The first ack wins; a second (a hedged copy that
  finished later, a replay racing a completion from before the crash) is
  suppressed and counted (`journal/duplicate_acks`).

`replay()` gives every accepted request without an ack, in accept order.
A request's codes are a function of its text, seed, temperature and
cond_scale alone (one generator per request), so a replay is a
resubmission.  Requests are keyed by a content uid, the hash of those four,
the same for every hop of a logical request and across process restarts.

The JAX journal hashes the request's PRNG key words; the port's requests
carry a seed in their place, so the uid hashes the seed.  A request that
brings its own noise cannot be journaled: replaying it would need the
noise, which the journal does not hold, so the engine refuses such a
request while a journal is attached.  A torn final line (a crash in the
middle of an append) is skipped and counted (`journal/torn_records`).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List

import numpy as np

from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics

JOURNAL_NAME = "journal.jsonl"

# outcomes that retire a journaled request; "deferred" is not one: a request
# queued or in flight when the process ends stays open for the next replay
ACK_OUTCOMES = ("completed", "shed", "poisoned", "requeue_exhausted")


def request_uid(text, seed: int, temperature: float = 1.0, cond_scale: float = 1.0) -> str:
    """The content id of one logical request: a sha1 of what sets its
    codes (seed, text ids, temperature, cond_scale)."""
    blob = json.dumps([int(seed), np.asarray(text).ravel().tolist(), round(float(temperature), 8),
                       round(float(cond_scale), 8)], separators=(",", ":")).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _fsync_dir(path: str) -> None:
    """fsync the file's directory, so that a journal just created survives
    the crash it is there for."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class RequestJournal:
    """The journal in `dir_path`.  Opening one that exists (a restart) reads
    it first, so acks and `replay()` see what came before; appends continue
    the same file."""

    def __init__(self, dir_path: str, progress_every: int = 8):
        self.dir = dir_path
        self.path = os.path.join(dir_path, JOURNAL_NAME)
        self.progress_every = max(int(progress_every), 1)
        os.makedirs(dir_path, exist_ok=True)
        self._accepted: Dict[str, Dict[str, Any]] = {}
        self._progress: Dict[str, int] = {}
        self._acked: Dict[str, str] = {}
        self._order: List[str] = []
        for rec in self._scan():
            self._absorb(rec)
        self._f = open(self.path, "a", encoding="utf-8")
        _fsync_dir(self.path)

    def _scan(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        out: List[Dict[str, Any]] = []
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    # torn by a crash mid-append: that record was never durable
                    obs_metrics.counter("journal/torn_records").inc()
                    break
        return out

    def _absorb(self, rec: Dict[str, Any]) -> None:
        kind, uid = rec.get("kind"), rec.get("uid")
        if not uid:
            return
        if kind == "accepted":
            if uid not in self._accepted:
                self._order.append(uid)
            self._accepted[uid] = rec
        elif kind == "progress":
            self._progress[uid] = max(self._progress.get(uid, 0), int(rec.get("codes_done", 0)))
        elif kind == "ack":
            self._acked.setdefault(uid, rec.get("outcome", "completed"))

    def _append(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def accepted(self, req) -> str:
        """Journal an accepted request, fsynced before it returns; stamps
        `req.journal_uid`.  A uid already known (a requeued or replayed
        request) appends nothing."""
        uid = getattr(req, "journal_uid", None) or request_uid(req.text, req.seed, req.temperature, req.cond_scale)
        req.journal_uid = uid
        if uid in self._acked or uid in self._accepted:
            return uid
        rec = {"kind": "accepted", "uid": uid, "t": time.time(), "text": np.asarray(req.text).ravel().tolist(),
               "seed": int(req.seed), "temperature": float(req.temperature), "cond_scale": float(req.cond_scale),
               "synthetic": bool(getattr(req, "synthetic", False)), "deadline_s": getattr(req, "deadline_s", None),
               "retries_left": getattr(req, "retries_left", None)}
        self._absorb(rec)
        self._append(rec)
        obs_metrics.counter("journal/accepted").inc()
        return uid

    def progress(self, req) -> None:
        """Record `req.codes_done`, the codes made and the request's
        position in its randomness (a host counter)."""
        uid = getattr(req, "journal_uid", None)
        if uid is None or uid in self._acked:
            return
        done = int(req.codes_done)
        if done <= self._progress.get(uid, 0):
            return
        self._progress[uid] = done
        self._append({"kind": "progress", "uid": uid, "codes_done": done, "rng_pos": done})

    def ack(self, req, outcome: str) -> bool:
        """Acknowledge a terminal outcome.  True for the uid's first ack; a
        later one is suppressed and counted."""
        uid = getattr(req, "journal_uid", None)
        if uid is None:
            return True  # never journaled (the journal came after it)
        if uid in self._acked:
            obs_metrics.counter("journal/duplicate_acks").inc()
            return False
        self._acked[uid] = outcome
        self._append({"kind": "ack", "uid": uid, "outcome": outcome, "t": time.time()})
        obs_metrics.counter(f"journal/ack_{outcome}").inc()
        return True

    def next_free_seed(self) -> int:
        """One past the largest seed journaled (0 for an empty journal)."""
        return 1 + max((int(rec["seed"]) for rec in self._accepted.values()), default=-1)

    def unacknowledged(self) -> List[str]:
        return [u for u in self._order if u not in self._acked]

    def replay(self) -> List[Dict[str, Any]]:
        """Every accepted request without an ack, in accept order, ready to
        submit again: text, seed, settings, budgets, and `codes_done`, how
        far the crashed process had come."""
        out: List[Dict[str, Any]] = []
        for uid in self.unacknowledged():
            rec = self._accepted[uid]
            out.append({"uid": uid, "text": np.asarray(rec["text"], dtype=np.int64), "seed": int(rec["seed"]),
                        "temperature": float(rec.get("temperature", 1.0)),
                        "cond_scale": float(rec.get("cond_scale", 1.0)),
                        "synthetic": bool(rec.get("synthetic", False)), "deadline_s": rec.get("deadline_s"),
                        "retries_left": rec.get("retries_left"), "codes_done": self._progress.get(uid, 0)})
        return out

    def stats(self) -> Dict[str, int]:
        return {"accepted": len(self._accepted), "acked": len(self._acked),
                "unacknowledged": len(self.unacknowledged())}

    def close(self) -> None:
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except (OSError, ValueError):
            pass
        self._f.close()
