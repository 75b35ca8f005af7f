"""Seeded journal records for the observability tests of the port.

``records(seed, now)`` builds what three workers' journal segments would
hold: counters snapshots, queue waits, task spans (one failed), stage,
storage and device spans, and two cumulative device ledgers a worker (the
later one with a recompile storm, near-full memory or an idle card on
some workers), all from ``numpy.random.default_rng(seed)`` and times
relative to ``now``. ``write_segments`` lays them out as raw segments
under a journal path, one file a worker, as ``Journal.flush`` would.
"""

import json
import os

import numpy as np

NOW = 1_800_000_000.0


def _span(worker, name, ts, dur, trace, span, parent=None, **attrs):
  rec = {"kind": "span", "worker": worker, "trace": trace, "span": span,
         "parent": parent, "name": name, "ts": ts, "dur": dur}
  rec.update(attrs)
  return rec


def records(seed: int = 0, now: float = NOW, workers: int = 3,
            tasks: int = 6) -> list:
  rng = np.random.default_rng(seed)
  out = []
  for w in range(workers):
    worker = f"w{w}"
    out.append({
      "kind": "counters", "worker": worker, "ts": now - 400.0, "event": "interval",
      "counters": {"tasks.failed": 0}, "timers": {}, "gauges": {},
    })
    slow = 5.0 if w == workers - 1 else 1.0  # the last worker straggles
    for i in range(tasks):
      t = f"{seed}t{w}{i}"
      ts = now - 300.0 + 40.0 * i + w
      dur = round(float(rng.uniform(0.1, 1.0)) * slow, 6)
      out.append(_span(worker, "queue.wait", ts - 2.0, 2.0, t, f"q{w}{i}", parent=f"x{w}{i}"))
      extra = {"error": "RuntimeError"} if (w == 1 and i == tasks - 1) else {}
      out.append(_span(worker, "task", ts, dur, t, f"x{w}{i}", task="DownsampleTask",
                       attempt=1, queue="FileQueue", **extra))
      out.append(_span(worker, "pipeline.download.s", ts, dur / 4, t, f"d{w}{i}",
                       parent=f"x{w}{i}"))
      out.append(_span(worker, "pipeline.download.producer_stall_s", ts, dur / 8, t,
                       f"s{w}{i}", parent=f"x{w}{i}"))
      out.append(_span(worker, "device.execute", ts + dur / 4, dur / 5, t, f"e{w}{i}",
                       parent=f"x{w}{i}", kernel="pyramid2x2x1",
                       elements=int(rng.integers(1, 1 << 26)), device="cuda:0",
                       devices=1))
      out.append(_span(worker, "device.h2d", ts + dur / 4, dur / 50, t, f"h{w}{i}",
                       parent=f"x{w}{i}", kernel=None, bytes=int(rng.integers(1, 1 << 26)),
                       device="cuda:0"))
      out.append(_span(worker, "storage.put", ts + dur / 2, dur / 10, t, f"p{w}{i}",
                       parent=f"x{w}{i}", protocol="file"))
    out.append({
      "kind": "counters", "worker": worker, "ts": now - 5.0 - w, "event": "round",
      "counters": {
        "tasks.failed": int(rng.integers(0, 3)), "dlq.promoted": int(w == 1),
        "zombie.renew": int(rng.integers(0, 4)), "retries.storage_http": int(rng.integers(0, 9)),
        "pipeline.upload.submitted": int(rng.integers(10, 99)),
      },
      "timers": {"pipeline.download.s": {"sum": 1.5, "count": tasks}},
      "gauges": {"worker.up": 1.0},
    })
    for k, (age, rec) in enumerate(((200.0, 2), (2.0, 2 + 30 * (w == 0)))):
      busy = round(float(rng.uniform(0.01, 0.2)), 4) * (0.1 if w == 1 else 1.0)
      peak = int(80e9 * (0.95 if w == 2 else float(rng.uniform(0.1, 0.5))))
      out.append({
        "kind": "device", "worker": worker, "ts": now - age, "t_start": now - 600.0,
        "wall_s": 600.0 - age, "busy_s": busy * (600.0 - age), "busy_ratio": busy,
        "dispatches": 10 + 10 * k, "transfers": 4, "recompiles": rec,
        "distinct_signatures": 3,
        "kernels": {
          "pyramid2x2x1": {"compiles": 1, "compile_s": 41.5, "executes": 12 + k,
                           "execute_s": 0.0312, "elements": 1 << 30, "bytes": 1 << 30,
                           "cache_hits": 0, "devices": {"cuda:0": 12 + k},
                           "vox_per_sec": 3.4e10, "bytes_per_sec": 3.4e10},
          "edt_pass": {"compiles": 0, "compile_s": 0.0, "executes": 3, "execute_s": 0.2,
                       "elements": 1 << 27, "bytes": 1 << 29, "cache_hits": 1,
                       "devices": {"cuda:0": 3}, "vox_per_sec": 6.7e8,
                       "bytes_per_sec": None},
        },
        "devices": {"cuda:0": busy * (600.0 - age)},
        "fastpath": {"batched": 8 * (k + 1), "host": w},
        "compile_cache": {"hits": w, "misses": 1, "puts": 1, "corrupt": 0, "errors": 0,
                          "saved_s": 40.0 * w, "fetch_s": 0.25 * w},
        "pad_bytes": 1 << 20, "real_bytes": 1 << 30, "pad_waste_ratio": 1 / 1024,
        "h2d_bytes": 1 << 29, "d2h_bytes": 1 << 27, "h2d_MBps": 9000.0, "d2h_MBps": None,
        "hbm": {"cuda:0": {"bytes_in_use": peak // 2, "peak_bytes_in_use": peak,
                           "bytes_limit": int(80e9)}},
      })
  return out


def write_segments(journal_dir: str, recs: list) -> list:
  """One raw segment a worker under ``journal_dir`` (a directory); the
  segment names ``Journal.flush`` would give them."""
  os.makedirs(journal_dir, exist_ok=True)
  by = {}
  for rec in recs:
    by.setdefault(rec["worker"], []).append(rec)
  names = []
  for worker, rs in sorted(by.items()):
    name = f"{worker}-000000.jsonl"
    with open(os.path.join(journal_dir, name), "w") as f:
      f.write("\n".join(json.dumps(r) for r in rs) + "\n")
    names.append(name)
  return names
