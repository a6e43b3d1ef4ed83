"""Where the card's time goes on the port's main path. Run on a GPU:

    python -m arrow1_tpu_torch.profile_main_path [--rows N] [--seed S]

For the fused flagship (selectivity 0.5), the entry pipeline
(filter -> project -> group_by -> sort, materialized) at 1K and ~1M
groups, and the eager group_by at BASELINE config 2 (sum/mean/count/sum
on the dense-key path at G = 1000 and 100000, sum/count/min/max on the
sorted path at G = 2^20), it prints the host wall time of one run (median
of 5, each synchronised), the device time that torch.profiler's CUDA
trace records over 3 runs, the resulting idle share of the card, and the
kernels that take the most device time (kernel records only, so no time
is counted twice). Data is bench.py's recipe from ``--seed``; the
group_by's ``w`` column is int32 with 10% nulls.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

import arrow1_tpu_torch as pt


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _wall_ms(fn, runs=5) -> float:
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def profile(label: str, fn, runs: int = 3, top: int = 12) -> None:
    fn()   # warm-up: kernel builds, allocator
    wall = _wall_ms(fn)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # kernel records only: an operator's record repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _device_us(e) > 0]
    if not events:
        print(f"== {label}: wall {wall:.3f} ms per run (median of 5); the "
              "profiler recorded no device time: busy and idle share not "
              "measured")
        return
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / runs
    print(f"== {label}: wall {wall:.3f} ms per run (median of 5); "
          f"device busy {busy_ms:.3f} ms per run (torch.profiler); "
          f"idle share {max(0.0, 1 - busy_ms / wall):.1%}")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        ms = _device_us(e) / 1e3 / runs
        print(f"   {ms:9.4f} ms {ms / busy_ms:6.1%} x{e.count // runs:<3d} "
              f"{e.key[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = pt.resolve_device()
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{args.rows} rows, seed {args.seed}")
    rng = np.random.default_rng(args.seed)
    n = args.rows
    key, v, f = (torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 1 << 20, n).astype(np.int64),
        rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
        rng.standard_normal(n)))
    profile("flagship filter+project, selectivity 0.5",
            lambda: pt.filter_project_flagship(key, v, f, 0.0, -(1 << 30)))
    for label, ngroups, max_groups in (("1K groups", 1000, 65536),
                                       ("~1M groups", 1 << 20, 1 << 20)):
        batch = pt.record_batch({
            "k": rng.integers(0, ngroups, n).astype(np.int64),
            "v": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            "f": rng.standard_normal(n)}, device=dev)
        pipe = (pt.PipelineBuilder()
                .filter(pt.field("f") > 0.0)
                .project([pt.field("v") * 2 + 1], ["proj"])
                .group_by(["k"], [("proj", "sum"), ("v", "count")],
                          max_groups=max_groups)
                .sort([("proj_sum", "descending")])
                .compile())
        profile(f"pipeline, {label}", lambda: pipe(batch))
    dense = [("v", "sum"), ("v", "mean"), ("w", "count"), ("w", "sum")]
    for label, ngroups, aggs in (
            ("dense-key path, G=1000", 1000, dense),
            ("dense-key path, G=100000", 100_000, dense),
            ("sorted path, G=2^20", 1 << 20,
             [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")])):
        batch = pt.record_batch({
            "k": rng.integers(0, ngroups, n).astype(np.int64),
            "v": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)},
            device=dev)
        w = pt.Column(torch.from_numpy(rng.integers(
            -(1 << 20), 1 << 20, n).astype(np.int32)).to(dev), pt.int32,
            validity=torch.from_numpy(rng.random(n) >= 0.1).to(dev))
        batch = pt.RecordBatch(batch.columns + (w,), batch.names + ("w",))
        profile(f"eager group_by, {label}",
                lambda: pt.group_by(batch, ["k"], aggs))


if __name__ == "__main__":
    main()
