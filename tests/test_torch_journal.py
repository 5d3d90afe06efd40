"""The port's request journal (`serving/journal.py`) on the CPU, after the
JAX package's `tests/test_serving_durability.py`: an accepted request is
journaled before submit returns and acknowledged once at its end; a crash
leaves it unacknowledged, and a fresh engine replays it to the codes of
its batch-1 call under its seed; a duplicate acknowledgement is counted
and suppressed; progress records carry the request's position; a torn
final line is skipped and counted; a request that brings its own noise is
refused while a journal is attached (a replay would need the noise); and
the serve CLI crashes (`--inject_fault kill-fleet@N`) in one subprocess
and replays in another, every unacknowledged request completed with no
duplicate acknowledgement.

The uid hashes the request's seed where the JAX journal hashes its key
(`ROADMAP.md`, deliberate divergences)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.models import dalle as tdalle
from dalle_pytorch_tpu_torch.models import sampling as tsamp
from dalle_pytorch_tpu_torch.observability import metrics as obs_metrics
from dalle_pytorch_tpu_torch.observability import tracing
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from dalle_pytorch_tpu_torch.serving.journal import ACK_OUTCOMES, RequestJournal, request_uid
from dalle_pytorch_tpu_torch.serving.scheduler import Request

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(dim=64, depth=2, heads=2, dim_head=32, num_text_tokens=40, text_seq_len=6, num_image_tokens=32,
             image_fmap_size=4, shift_tokens=True, attn_types=("full", "axial_row"))
THRES = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_registry():
    obs_metrics.REGISTRY.reset()
    yield
    obs_metrics.REGISTRY.reset()


@pytest.fixture(scope="module")
def model():
    return tdalle.init_dalle(tdalle.DALLEConfig(**MODEL), torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def text():
    return np.random.default_rng(1).integers(1, 40, (4, 6))


def _engine(model, journal=None, **kw):
    engine = GenerationEngine(model, engine_cfg=EngineConfig(**dict(dict(num_slots=2, block_size=4,
                                                                          filter_thres=THRES), **kw)))
    if journal is not None:
        engine.attach_journal(journal)
    return engine


def _batch1(model, text_row, seed, cond_scale=1.0, temperature=1.0):
    return tsamp.sample_image_codes(model, torch.as_tensor(text_row)[None], torch.Generator().manual_seed(seed),
                                    filter_thres=THRES, cond_scale=cond_scale, temperature=temperature).numpy()[0]


def test_request_uid_is_the_payloads():
    text = np.arange(1, 7, dtype=np.int32)
    uid = request_uid(text, 3, 1.0, 1.0)
    assert uid == request_uid(text.astype(np.int64).tolist(), np.int64(3)) and len(uid) == 16
    assert uid != request_uid(text, 4) and uid != request_uid(text, 3, temperature=0.5)
    assert uid != request_uid(text, 3, cond_scale=3.0)
    req = Request(id=9, text=text, seed=3)
    assert tracing.journey_uid(req) == uid == req.trace_uid


def test_a_crash_leaves_requests_open_and_a_replay_gives_their_codes(model, text, tmp_path):
    """Three requests journaled, a few polls, then the process "crashes"
    (the engine is dropped with no close, no acks).  A new journal on the
    directory holds them open; a fresh engine replays them to the batch-1
    codes of their seeds and acknowledges each once."""
    journal = RequestJournal(str(tmp_path))
    engine = _engine(model, journal)
    reqs = [engine.submit(text[i], seed=20 + i, cond_scale=(3.0 if i == 1 else 1.0), deadline_s=9.0,
                          retries_left=2) for i in range(3)]
    for _ in range(4):
        engine.poll()
    journal.close()
    del engine

    again = RequestJournal(str(tmp_path))
    assert again.stats() == {"accepted": 3, "acked": 0, "unacknowledged": 3}
    payloads = again.replay()
    assert [p["uid"] for p in payloads] == [r.journal_uid for r in reqs]
    assert all(p["deadline_s"] == 9.0 and p["retries_left"] == 2 for p in payloads)
    fresh = _engine(model, again)
    redone = [fresh.submit(p["text"], seed=p["seed"], temperature=p["temperature"], cond_scale=p["cond_scale"],
                           replayed=True) for p in payloads]
    fresh.run_until_idle()
    for i, req in enumerate(redone):
        assert req.replayed and req.journal_uid == reqs[i].journal_uid
        np.testing.assert_array_equal(req.codes, _batch1(model, text[i], 20 + i, cond_scale=(3.0 if i == 1 else 1.0)))
    assert again.stats() == {"accepted": 3, "acked": 3, "unacknowledged": 0}
    assert obs_metrics.counter("journal/duplicate_acks").value == 0
    assert obs_metrics.counter("journal/ack_completed").value == 3
    again.close()


def test_the_first_ack_wins_and_a_duplicate_is_counted(model, text, tmp_path):
    journal = RequestJournal(str(tmp_path))
    engine = _engine(model, journal)
    req = engine.submit(text[0], seed=5)
    engine.run_until_idle()
    assert req.outcome == "completed" and journal.stats() == {"accepted": 1, "acked": 1, "unacknowledged": 0}
    assert journal.ack(req, "completed") is False
    assert obs_metrics.counter("journal/duplicate_acks").value == 1
    # the same payload submitted again (a hedged copy) journals nothing new, and its ack is the duplicate
    copy = engine.submit(text[0], seed=5)
    engine.run_until_idle()
    assert copy.journal_uid == req.journal_uid and obs_metrics.counter("journal/duplicate_acks").value == 2
    assert obs_metrics.counter("journal/accepted").value == 1
    journal.close()
    kinds = [json.loads(line)["kind"] for line in open(journal.path)]
    assert kinds.count("ack") == 1 and kinds.count("accepted") == 1
    assert "deferred" not in ACK_OUTCOMES


def test_progress_records_the_position_and_a_replay_reports_the_furthest(model, text, tmp_path):
    journal = RequestJournal(str(tmp_path), progress_every=4)
    engine = _engine(model, journal)
    engine.submit(text[1], seed=6)
    for _ in range(10):
        engine.poll()
    journal.close()
    prog = [r for r in map(json.loads, open(journal.path)) if r["kind"] == "progress"]
    assert [r["codes_done"] for r in prog] == [4, 8] and all(r["codes_done"] == r["rng_pos"] for r in prog)
    assert RequestJournal(str(tmp_path)).replay()[0]["codes_done"] == 8


def test_a_torn_final_line_is_skipped_and_counted(tmp_path):
    journal = RequestJournal(str(tmp_path))
    req = Request(id=0, text=np.arange(1, 7), seed=8)
    journal.accepted(req)
    journal.close()
    with open(journal.path, "a") as f:
        f.write('{"kind":"ack","uid":"' + req.journal_uid)  # a crash mid-append
    again = RequestJournal(str(tmp_path))
    assert obs_metrics.counter("journal/torn_records").value == 1
    assert again.stats() == {"accepted": 1, "acked": 0, "unacknowledged": 1}
    assert again.replay()[0]["uid"] == req.journal_uid and again.replay()[0]["seed"] == 8
    again.close()


def test_a_request_with_noise_is_refused_while_a_journal_is_attached(model, text, tmp_path):
    cfg = model.cfg
    journal = RequestJournal(str(tmp_path))
    engine = _engine(model, journal, noise_override=True)
    noise = np.zeros((cfg.image_seq_len, cfg.total_tokens), np.float32)
    with pytest.raises(ValueError, match="a request with noise cannot be journaled"):
        engine.submit(text[0], noise=noise)
    assert not engine.busy and journal.stats()["accepted"] == 0
    engine.attach_journal(None)
    assert engine.submit(text[0], noise=noise).noise is not None
    journal.close()


def _serve(argv, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "dalle_pytorch_tpu_torch.cli.serve", *argv], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=timeout)


def test_serve_cli_crashes_and_replays_in_two_processes(tmp_path):
    """`--inject_fault kill-fleet@6` SIGKILLs the first process mid-run;
    the second, with the same `--journal` and no other traffic, replays
    what it left open: every request acknowledged, none twice."""
    base = ["--synthetic", "--dim", "32", "--depth", "2", "--image_fmap_size", "4", "--slots", "2",
            "--block_size", "8", "--replicas", "2", "--journal", str(tmp_path / "j"), "--device", "cpu"]
    crashed = _serve(base + ["--loadgen", "6", "--rate", "200", "--inject_fault", "kill-fleet@6"])
    assert crashed.returncode == -9, crashed.stderr[-2000:]
    assert "[chaos] kill-fleet" in crashed.stdout
    open_after = RequestJournal(str(tmp_path / "j")).stats()
    assert open_after["accepted"] == 6 and open_after["unacknowledged"] > 0
    replay = _serve(base + ["--report_json", str(tmp_path / "r.json")])
    assert replay.returncode == 0, replay.stderr[-2000:]
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["journal_replayed"] == report["journal_replay_completed"] == open_after["unacknowledged"]
    assert report["journal_unacknowledged"] == 0 and report["journal_acked"] == 6
    assert report["journal_duplicate_acks"] == 0
