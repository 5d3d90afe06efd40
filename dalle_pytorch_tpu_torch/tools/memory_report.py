"""Render a run's HBM story from its telemetry spans JSONL (counterpart of
the JAX package's `tools/memory_report.py`, which reads the same files).

    python -m dalle_pytorch_tpu_torch.tools.memory_report RUN.telemetry/dalle.spans.jsonl
    python -m dalle_pytorch_tpu_torch.tools.memory_report RUN.telemetry   # picks *.spans.jsonl

Four sections, all from the one stream observability/memory.py writes:

* the analytic HBM **ledger** (`kind:"mem_ledger"`) — per-chip bytes by row
  (params / grads / optimizer state / activations ...), dominant row, and
  the fits/doesn't-fit verdict against device capacity;
* the **crosscheck** (`kind:"memory_crosscheck"`) — the measured step
  (its peak, `max_memory_allocated`) beside the ledger, the
  measured/analytic ratio trajectory, and the in-place audit (did the step
  leave a second copy of the state?);
* the live **peak timeline** — `kind:"mem_window"` records (bytes_in_use,
  per-window peak delta, usage fraction) plus the `device_peak_bytes_in_use`
  gauge from metric snapshots;
* memory **alarms** — `hbm_headroom`, `mem_divergence`, `donation_dropped`
  — and any OOM reports counted.

Pure stdlib; works on a partially-written file from a live run."""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

from dalle_pytorch_tpu_torch.tools.telemetry_report import load_records  # the same torn-line tolerance

_MEM_ALARMS = ("hbm_headroom", "mem_divergence", "donation_dropped")


def _gb(v) -> str:
    return f"{v / 1e9:.3f}" if v is not None else "-"


def build_report(records: List[Dict[str, Any]], max_rows: int = 30) -> str:
    ledgers = [r for r in records if r.get("kind") == "mem_ledger"]
    checks = [r for r in records if r.get("kind") == "memory_crosscheck"]
    windows = [r for r in records if r.get("kind") == "mem_window"]
    alarms = [r for r in records if r.get("kind") == "alarm"
              and r.get("type") in _MEM_ALARMS]
    metric_peaks = []
    for r in records:
        if r.get("kind") != "metrics":
            continue
        rec = (r.get("metrics") or {}).get("device_peak_bytes_in_use")
        if rec and rec.get("last") is not None:
            metric_peaks.append((r.get("step"), rec["last"]))

    out: List[str] = []
    if ledgers:
        led = ledgers[-1]  # the live-tree refresh supersedes the estimate
        out.append(f"analytic HBM ledger (per chip; {len(ledgers)} snapshot(s),"
                   " showing the last)")
        total = led.get("total_bytes") or 0.0
        for row in led.get("rows", []):
            pct = 100.0 * row["bytes"] / total if total > 0 else 0.0
            mark = "  <-- dominant" if row["name"] == led.get("dominant") else ""
            out.append(f"  {row['name']:<14} {_gb(row['bytes']):>9} GB "
                       f"{pct:>5.1f}%  {row.get('detail', '')}{mark}")
        out.append(f"  {'TOTAL':<14} {_gb(total):>9} GB")
        cap = led.get("capacity_bytes")
        if cap:
            verdict = "FITS" if led.get("fits") else "DOES NOT FIT"
            out.append(f"  capacity       {_gb(cap):>9} GB -> {verdict} "
                       f"(headroom {100.0 * (led.get('headroom_frac') or 0):.1f}%)")
        if led.get("lower_bound"):
            out.append("  (activations not modeled — the total is a LOWER bound)")
    else:
        out.append("no mem_ledger records (run with telemetry enabled?)")

    if checks:
        out.append("")
        out.append("measured step crosscheck (max_memory_allocated)")
        for c in checks[-3:]:
            ratio = c.get("ratio")
            out.append(
                f"  [{c.get('label', '?')}] measured/analytic="
                f"{ratio if ratio is None else round(ratio, 4)}  "
                f"arg={_gb(c.get('argument_bytes'))}GB "
                f"temp={_gb(c.get('temp_bytes'))}GB "
                f"out={_gb(c.get('output_bytes'))}GB "
                f"aliased={_gb(c.get('alias_bytes'))}GB "
                f"total={_gb(c.get('total_bytes'))}GB"
            )
            don = c.get("donation")
            if don:
                status = "OK" if don.get("ok") else "SECOND COPY"
                frac = don.get("donated_frac")
                out.append(f"    in-place audit: {status} "
                           f"(updated in place {_gb(don.get('donated_bytes'))}GB of "
                           f"{_gb(don.get('expected_bytes'))}GB expected"
                           + (f", {100 * frac:.0f}%" if frac is not None else "")
                           + ")")

    timeline = [(w.get("step"), w.get("bytes_in_use"),
                 w.get("peak_bytes_in_use"), w.get("peak_window_delta_bytes"),
                 w.get("usage_frac")) for w in windows]
    if not timeline and metric_peaks:
        timeline = [(s, None, p, None, None) for s, p in metric_peaks]
    if timeline:
        out.append("")
        out.append("live HBM peak timeline")
        header = (f"  {'step':>8} {'in_use GB':>10} {'peak GB':>10} "
                  f"{'win delta GB':>13} {'usage':>7}")
        out.append(header)
        out.append("  " + "-" * (len(header) - 2))
        indexed = list(enumerate(timeline))
        shown = (indexed if len(indexed) <= max_rows
                 else indexed[:max_rows // 2] + indexed[-max_rows // 2:])
        prev_idx = None
        for idx, entry in shown:
            if prev_idx is not None and idx != prev_idx + 1:
                out.append(f"  {'...':>8}")
            prev_idx = idx
            step, in_use, peak, delta, usage = entry
            out.append(
                f"  {step if step is not None else '-':>8} "
                f"{_gb(in_use):>10} {_gb(peak):>10} {_gb(delta):>13} "
                + (f"{100 * usage:>6.1f}%" if usage is not None else f"{'-':>7}")
            )

    out.append("")
    if alarms:
        out.append(f"memory ALARMS ({len(alarms)}):")
        for a in alarms:
            detail = {k: v for k, v in a.items() if k not in ("kind", "ts")}
            out.append(f"  [{a.get('type')}] {detail}")
    else:
        out.append("memory alarms: none")
    return "\n".join(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", help="spans JSONL file, or a telemetry directory")
    parser.add_argument("--max-rows", type=int, default=30,
                        help="max timeline rows (head+tail beyond)")
    args = parser.parse_args(argv)
    try:
        print(build_report(load_records(args.path), max_rows=args.max_rows))
    except BrokenPipeError:  # `| head` closed the pipe — not an error
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
