"""Render a telemetry spans JSONL into a per-step time-attribution table
(counterpart of the JAX package's `tools/telemetry_report.py`, which reads
the same files).

    python -m dalle_pytorch_tpu_torch.tools.telemetry_report RUN.telemetry/dalle.spans.jsonl
    python -m dalle_pytorch_tpu_torch.tools.telemetry_report RUN.telemetry   # picks *.spans.jsonl

For each step record it attributes wall-clock to the top-level spans
(data_wait / dispatch / block / checkpoint / log / ...) and prints a
percentage table plus an aggregate attribution, the aggregate-span stats
(decode etc.), and any alarms (rebuilds after warm-up, FLOPs drift, hangs,
headroom) — the "data-starved, build-thrashed, or kernel-bound?" answer in
one screen.  Several `.pN` files (the cross-process skew column) wait for
the fleet's report (ROADMAP.md Queue 1 item 7).  Pure stdlib; works on a
partially-written file from a live run."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List


def load_records(path: str) -> List[Dict[str, Any]]:
    p = Path(path)
    if p.is_dir():
        candidates = sorted(p.glob("*.spans.jsonl"))
        if not candidates:
            raise SystemExit(f"no *.spans.jsonl under {p}")
        p = candidates[0]
    records = []
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line from a live run
    return records


def _fmt_s(v: float) -> str:
    return f"{v:.4f}" if v < 10 else f"{v:.2f}"


def build_report(records: List[Dict[str, Any]], max_rows: int = 40,
                 skew_by_step: Dict[int, float] = None) -> str:
    steps = [r for r in records if r.get("kind") == "step" and r.get("step") is not None]
    alarms = [r for r in records if r.get("kind") in ("alarm", "hang")]
    checks = [r for r in records if r.get("kind") == "flops_crosscheck"]
    compile_summaries = [r for r in records if r.get("kind") == "compile_summary"]
    metrics = [r for r in records if r.get("kind") == "metrics"]
    healths = {r.get("step"): r for r in records if r.get("kind") == "health"}
    # peak-HBM column: mem_window records (observability/memory.HbmMonitor)
    # or the device_peak_bytes_in_use gauge — sampled at the flush cadence,
    # so most steps show '-' and flush steps carry the number
    peak_by_step: Dict[Any, float] = {}
    for r in records:
        if r.get("kind") == "mem_window" and r.get("peak_bytes_in_use") is not None:
            peak_by_step[r.get("step")] = r["peak_bytes_in_use"]
        elif r.get("kind") == "metrics":
            rec = (r.get("metrics") or {}).get("device_peak_bytes_in_use")
            if rec and rec.get("last") is not None:
                peak_by_step.setdefault(r.get("step"), rec["last"])

    out: List[str] = []
    if not steps:
        out.append("no step records found (run with telemetry enabled?)")
    else:
        names: List[str] = []
        for s in steps:
            for k in s.get("spans", {}):
                if k not in names:
                    names.append(k)
        other_needed = any(
            s.get("dur_s", 0) - sum(s.get("spans", {}).values()) > 1e-9 for s in steps
        )
        cols = names + (["other"] if other_needed else [])
        header = f"{'step':>6} {'total_s':>8} " + " ".join(f"{n + ' %':>12}" for n in cols)
        if skew_by_step is not None:
            # cross-process max skew (multi-file invocation): max-min step
            # seconds across every process that recorded this step
            header += f" {'xproc skew_s':>13}"
        if peak_by_step:
            header += f" {'peak HBM GB':>12}"
        if healths:
            # health-summary column: global grad-norm on health steps, the
            # first offending layer path when the step went non-finite
            header += f" {'health':>24}"
        out.append("per-step time attribution")
        out.append(header)
        out.append("-" * len(header))
        shown = steps if len(steps) <= max_rows else steps[:max_rows // 2] + steps[-max_rows // 2:]
        prev = None
        for s in shown:
            if prev is not None and s is not prev and steps.index(s) != steps.index(prev) + 1:
                out.append(f"{'...':>6}")
            prev = s
            total = s.get("dur_s") or 0.0
            spans = s.get("spans", {})
            row = [f"{s['step']:>6}", f"{_fmt_s(total):>8}"]
            accounted = 0.0
            for n in names:
                v = spans.get(n, 0.0)
                accounted += v
                pct = 100.0 * v / total if total > 0 else 0.0
                row.append(f"{pct:>11.1f}%")
            if other_needed:
                pct = 100.0 * max(total - accounted, 0.0) / total if total > 0 else 0.0
                row.append(f"{pct:>11.1f}%")
            if skew_by_step is not None:
                sk = skew_by_step.get(s["step"])
                row.append(f"{_fmt_s(sk):>13}" if sk is not None else f"{'-':>13}")
            if peak_by_step:
                pk = peak_by_step.get(s["step"])
                row.append(f"{pk / 1e9:>12.3f}" if pk is not None else f"{'-':>12}")
            if healths:
                h = healths.get(s["step"])
                if h is None:
                    hcol = "-"
                elif h.get("first_nonfinite"):
                    hcol = "NONFINITE " + h["first_nonfinite"]
                    if len(hcol) > 24:
                        hcol = hcol[:21] + "..."
                else:
                    g = h.get("grad_norm_global")
                    hcol = f"|g|={g:.3g}" if g is not None else "ok"
                row.append(f"{hcol:>24}")
            out.append(" ".join(row))

        # aggregate attribution over all steps
        total_all = sum(s.get("dur_s") or 0.0 for s in steps)
        out.append("")
        out.append(f"aggregate over {len(steps)} steps, {_fmt_s(total_all)}s total")
        accounted = 0.0
        for n in names:
            v = sum(s.get("spans", {}).get(n, 0.0) for s in steps)
            accounted += v
            pct = 100.0 * v / total_all if total_all > 0 else 0.0
            out.append(f"  {n:<16} {_fmt_s(v):>10}s  {pct:>5.1f}%")
        if other_needed and total_all > 0:
            v = max(total_all - accounted, 0.0)
            out.append(f"  {'other':<16} {_fmt_s(v):>10}s  {100.0 * v / total_all:>5.1f}%")

        # aggregate spans (per-sample work folded into counts)
        agg: Dict[str, List[float]] = {}
        for s in steps:
            for k, rec in s.get("agg", {}).items():
                slot = agg.setdefault(k, [0, 0.0])
                slot[0] += rec.get("n", 0)
                slot[1] += rec.get("total_s", 0.0)
        if agg:
            out.append("")
            out.append("aggregated spans (count, total, mean)")
            for k, (n, t) in sorted(agg.items()):
                mean = t / n if n else 0.0
                out.append(f"  {k:<24} n={n:<8} total={_fmt_s(t)}s mean={mean * 1e3:.2f}ms")

    if checks:
        out.append("")
        out.append("FLOPs cross-checks (measured: the aten products + the flash kernels' tally / analytic)")
        for c in checks:
            ratio = c.get("ratio")
            out.append(
                f"  {c.get('label', '?')}: ratio={ratio if ratio is None else round(ratio, 4)} "
                f"(compiled={c.get('compiled_flops'):.3e}, analytic={c.get('analytic_flops'):.3e})"
            )
    if compile_summaries:
        cs = compile_summaries[-1]
        out.append("")
        out.append(
            f"builds: {cs.get('compiles', 0)} "
            f"(after warm-up: {cs.get('recompiles', 0)}, "
            f"{cs.get('compile_time_s', 0)}s total)"
        )
    if metrics:
        last = metrics[-1].get("metrics", {})
        if last:
            out.append("")
            out.append(f"last metrics snapshot (step {metrics[-1].get('step')})")
            for name, rec in sorted(last.items()):
                brief = {k: v for k, v in rec.items()
                         if k not in ("log2_buckets", "kind") and v is not None}
                out.append(f"  {name:<32} {brief}")
    out.append("")
    if alarms:
        out.append(f"ALARMS ({len(alarms)}):")
        for a in alarms:
            detail = {k: v for k, v in a.items() if k not in ("kind", "ts")}
            out.append(f"  [{a['kind']}] {detail}")
    else:
        out.append("alarms: none")
    return "\n".join(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", nargs="+", help="a spans JSONL file, or a telemetry directory")
    parser.add_argument("--max-rows", type=int, default=40,
                        help="max per-step rows to print (head+tail beyond)")
    args = parser.parse_args(argv)
    skew = None
    if len(args.path) > 1:
        raise SystemExit("several span files (the cross-process skew column) wait for the fleet's report "
                         "(ROADMAP.md Queue 1 item 7)")
    try:
        print(build_report(load_records(args.path[0]), max_rows=args.max_rows,
                           skew_by_step=skew))
    except BrokenPipeError:  # `| head` closed the pipe — not an error
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
