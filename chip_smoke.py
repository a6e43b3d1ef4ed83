#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (arrow1_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout:

    python3 chip_smoke.py

It builds every CUDA kernel from arrow1_tpu_torch/csrc (one nvcc per
source, all at once), then:

1. prints the card's name and power limit (nvidia-smi) and the build time;
2. holds the compaction kernel (K2) against its plain PyTorch version,
   bit for bit, at n in {1, 1000, 4097, 10M} and selectivities
   {0, 0.01, 0.5, 0.99, 1} over mixed i64/f64/i32/f32/bool columns and a
   validity stream, and times kernel, plain version and library call
   (boolean-mask indexing per column) with CUDA events;
3. holds the fused filter+project kernel (K1) against its plain version
   at 10M rows of bench.py's data recipe, selectivities 0.25 and 0.5;
4. drives the main path through the entry points a user calls: the
   entry pipeline (filter -> project -> group_by -> sort, materialized)
   at 10M rows with 1K groups and with ~1M groups (max_groups = 2^20, the
   K2 segment path), and the fused flagship at 10M rows. Every launch
   count is set to 0 just before and read just after; each kernel must
   have launched. The pipeline results must equal an independent numpy
   oracle. The K2 calls the pipeline made are captured in a separate,
   uncounted run and replayed against the plain version and timed.

The line before the last is a JSON object with one entry per kernel
(time, bound, plain and library times, launches, error); the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
it, it exits non-zero and prints no result. Any failure exits non-zero.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda:0"   # one card
N_BIG = 10_000_000
RUNS = 20
# HBM bandwidth from NVIDIA's data sheets, by device name (first match)
PEAK_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                    ("H200", 4.8e12), ("H100", 3.35e12))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _peak(name: str) -> float:
    for key, rate in PEAK_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM bandwidth on record for {name!r}")


def _bits(t):
    """Integer view of a tensor, so equality is bit equality."""
    return {torch.float64: lambda: t.view(torch.int64),
            torch.float32: lambda: t.view(torch.int32)}.get(
        t.dtype, lambda: t)()


def _max_abs_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.bool:
        return float((a != b).any())
    return float((a.double() - b.double()).abs().max())


def _time_ms(fn, runs=RUNS, warmup=3) -> float:
    """Median of per-call times by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


class _Recorder:
    """Stands in for ``compact`` in the modules that call it, keeping a
    copy of the inputs of each distinct call shape."""

    def __init__(self, real):
        self.real = real
        self.calls = {}

    def __call__(self, mask, cols, out_limit=None):
        key = (mask.shape[0], tuple(str(c.dtype) for c in cols), out_limit)
        if key not in self.calls:
            self.calls[key] = (mask.clone(), [c.clone() for c in cols],
                               out_limit)
        return self.real(mask, cols, out_limit)


def _check_compact(compact, compact_plain, mask, cols, out_limit=None):
    """Kernel vs plain version, bit for bit; returns the max abs error."""
    outs, count = compact(mask, cols, out_limit)
    pouts, pcount = compact_plain(mask, cols, out_limit)
    k = int(pcount)
    if int(count) != k:
        raise AssertionError(f"compact count {int(count)} != plain {k}")
    kk = min(k, outs[0].shape[0]) if outs else 0
    err = 0.0
    for o, p in zip(outs, pouts):
        if not torch.equal(_bits(o[:kk]), _bits(p[:kk])):
            raise AssertionError(f"compact output differs ({o.dtype}, n="
                                 f"{mask.shape[0]}, kept {k})")
        err = max(err, _max_abs_err(o[:kk], p[:kk]))
    return err, k


def _compact_bytes(n, cols, count) -> int:
    width = sum(c.element_size() for c in cols)
    return n + n * width + count * width   # mask, columns, kept rows


def phase_compaction(pt_kernels, dev, peak):
    compact = pt_kernels.compaction.compact
    compact_plain = pt_kernels.compaction.compact_plain
    rng = np.random.default_rng(0)
    err = 0.0
    for n in (1, 1000, 4097, N_BIG):
        host = [rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64),
                rng.standard_normal(n),
                rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
                rng.standard_normal(n).astype(np.float32),
                rng.random(n) < 0.5,
                rng.random(n) < 0.9]
        cols = [torch.from_numpy(c).to(dev) for c in host]
        for sel in (0.0, 0.01, 0.5, 0.99, 1.0):
            mask = torch.from_numpy(rng.random(n) < sel).to(dev)
            e, k = _check_compact(compact, compact_plain, mask, cols)
            err = max(err, e)
        e, _ = _check_compact(compact, compact_plain, mask, cols,
                              out_limit=n // 3)
        err = max(err, e)
        print(f"K2 compact n={n}: bit-equal to plain at selectivities "
              "0, 0.01, 0.5, 0.99, 1 and with out_limit", flush=True)
    # the materialize-like shape: 10M rows of (i64, i64, f64) at 0.5
    cols = [torch.from_numpy(c).to(dev) for c in (
        rng.integers(0, 1 << 20, N_BIG).astype(np.int64),
        rng.integers(-(1 << 30), 1 << 30, N_BIG).astype(np.int64),
        rng.standard_normal(N_BIG))]
    mask = torch.from_numpy(rng.random(N_BIG) < 0.5).to(dev)
    e, k = _check_compact(compact, compact_plain, mask, cols)
    err = max(err, e)
    ms = _time_ms(lambda: compact(mask, cols))
    bound = _compact_bytes(N_BIG, cols, k) / peak * 1e3
    print(f"K2 compact 10M x (i64,i64,f64) sel 0.5: kernel {ms:.4f} ms, "
          f"bound {bound:.4f} ms ({bound / ms:.1%} of the HBM bound)",
          flush=True)
    return err


def _flagship_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 20, n).astype(np.int64),
            rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            rng.standard_normal(n))


def _vthr(sel):
    """bench.py: with f > 0 keeping half, P(v > vthr) = 2*sel."""
    return int((1.0 - 2.0 * min(2.0 * sel, 1.0)) * (1 << 30))


def phase_fused(fused, dev, peak):
    key, v, f = (torch.from_numpy(a).to(dev) for a in _flagship_data(N_BIG))
    err = 0.0
    rows = {}
    for sel in (0.25, 0.5):
        vthr = _vthr(sel)
        ko, po, c = fused.filter_project_flagship(key, v, f, 0.0, vthr)
        pk, pp, pc = fused.filter_project_plain(key, v, f, 0.0, vthr)
        k = int(pc)
        if int(c) != k or not torch.equal(ko[:k], pk[:k]) or \
                not torch.equal(_bits(po[:k]), _bits(pp[:k])):
            raise AssertionError(f"K1 differs from plain at sel {sel}")
        err = max(err, _max_abs_err(ko[:k], pk[:k]),
                  _max_abs_err(po[:k], pp[:k]))
        ms = _time_ms(lambda: fused.filter_project_flagship(
            key, v, f, 0.0, vthr))
        plain_ms = _time_ms(lambda: fused.filter_project_plain(
            key, v, f, 0.0, vthr))
        nbytes = N_BIG * 24 + k * 16   # read key, v, f; write kept rows
        bound = nbytes / peak * 1e3
        print(f"K1 flagship 10M sel {sel} (kept {k}): bit-equal; kernel "
              f"{ms:.4f} ms = {N_BIG / ms * 1e3:.4g} rows/s, "
              f"{nbytes / ms * 1e3:.4g} B/s = {bound / ms:.1%} of HBM; "
              f"plain {plain_ms:.4f} ms", flush=True)
        rows[sel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
    return err, rows


def _oracle(k, v, f):
    """Independent numpy answer of the entry pipeline: per-key sums of
    v*2+1 and counts over rows with f > 0, ordered by sum descending,
    ties by key."""
    live = f > 0.0
    kl = k[live]
    proj = v[live] * 2 + 1
    order = np.argsort(kl, kind="stable")
    ks = kl[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    keys = ks[starts]
    sums = np.add.reduceat(proj[order], starts)
    counts = np.diff(np.r_[starts, len(ks)])
    out = np.argsort(-sums, kind="stable")
    return keys[out], sums[out], counts[out]


def _entry_pipeline(pt, max_groups):
    return (pt.PipelineBuilder()
            .filter(pt.field("f") > 0.0)
            .project([pt.field("v") * 2 + 1], ["proj"])
            .group_by(["k"], [("proj", "sum"), ("v", "count")],
                      max_groups=max_groups)
            .sort([("proj_sum", "descending")])
            .compile())


def _check_pipeline(out, want, label):
    keys, sums, counts = want
    if out.num_rows != len(keys):
        raise AssertionError(f"{label}: {out.num_rows} groups, oracle "
                             f"{len(keys)}")
    got = {n: out[n].data.cpu().numpy() for n in out.names}
    for name, ref in (("k", keys), ("proj_sum", sums), ("v_count", counts)):
        if not np.array_equal(got[name], ref):
            raise AssertionError(f"{label}: column {name} differs from the "
                                 "numpy oracle")
    valid = out["proj_sum"].validity
    if valid is not None and not bool(valid.all()):
        raise AssertionError(f"{label}: null sums")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import arrow1_tpu_torch as pt
    import arrow1_tpu_torch.ops.padded as padded
    import arrow1_tpu_torch.ops.selection as selection
    from arrow1_tpu_torch import kernels as pt_kernels
    from arrow1_tpu_torch.kernels import build, compaction, fused_ops

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    card = _card_line()
    peak = _peak(name)
    t0 = time.perf_counter()
    build.build(build.SOURCES)
    build_s = time.perf_counter() - t0
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; HBM peak {peak:.3g} B/s (data sheet); "
          f"kernels built in {build_s:.1f} s", flush=True)
    for src in build.SOURCES:
        log = build.library_path(src).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    k2_err = phase_compaction(pt_kernels, dev, peak)
    k1_err, k1_rows = phase_fused(fused_ops, dev, peak)

    # ---- phase 4: the main path at full size --------------------------
    rng = np.random.default_rng(0)
    configs = []
    for label, ngroups, max_groups in (("1K groups", 1000, 65536),
                                       ("1M groups", 1 << 20, 1 << 20)):
        k = rng.integers(0, ngroups, N_BIG).astype(np.int64)
        v = rng.integers(-(1 << 30), 1 << 30, N_BIG).astype(np.int64)
        f = rng.standard_normal(N_BIG)
        batch = pt.record_batch({"k": k, "v": v, "f": f}, device=dev)
        configs.append((label, batch, _entry_pipeline(pt, max_groups),
                        _oracle(k, v, f)))
    fkey, fv, ff = (torch.from_numpy(a).to(dev)
                    for a in _flagship_data(N_BIG))

    # capture run (uncounted): record the K2 calls the pipeline makes
    recorder = _Recorder(compaction.compact)
    padded.compact = selection.compact = recorder
    try:
        for label, batch, pipe, want in configs:
            _check_pipeline(pipe(batch), want, label)
    finally:
        padded.compact = selection.compact = compaction.compact

    kernels = (compaction.compact, fused_ops.filter_project_flagship)
    for kern in kernels:
        kern.launches = 0
    per_run = []
    for label, batch, pipe, want in configs:
        before = compaction.compact.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_pipeline(out, want, label)
        per_run.append((label, wall, compaction.compact.launches - before))
    for sel in (0.25, 0.5):
        fused_ops.filter_project_flagship(fkey, fv, ff, 0.0, _vthr(sel))
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in kernels}
    for label, wall, n_launch in per_run:
        if n_launch <= 0:
            raise AssertionError(f"pipeline ({label}) launched no K2")
        print(f"pipeline 10M rows, {label}: matches the numpy oracle; "
              f"wall {wall * 1e3:.3f} ms (first counted run); K2 launches "
              f"{n_launch}", flush=True)
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{kname} was not launched on the main "
                                 "path")
    print(f"main path launches: {launches}", flush=True)
    for label, batch, pipe, want in configs:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"pipeline 10M rows, {label}: wall "
              f"{statistics.median(walls) * 1e3:.3f} ms (median of 3)",
              flush=True)

    # replay the captured K2 calls: kernel vs plain, and their times
    k2_row = None
    for (n, dtypes, out_limit), (mask, cols, lim) in sorted(
            recorder.calls.items(), key=lambda kv: kv[0][0]):
        e, k = _check_compact(compaction.compact, compaction.compact_plain,
                              mask, cols, lim)
        k2_err = max(k2_err, e)
        ms = _time_ms(lambda: compaction.compact(mask, cols, lim))
        plain_ms = _time_ms(lambda: compaction.compact_plain(mask, cols,
                                                             lim))
        lib_ms = _time_ms(lambda: [c[mask] for c in cols])
        bound = _compact_bytes(n, cols, k) / peak * 1e3
        print(f"K2 on the main path: n={n} cols={list(dtypes)} kept {k}: "
              f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"mask indexing {lib_ms:.4f} ms, bound {bound:.4f} ms",
              flush=True)
        if k2_row is None or n * len(cols) >= k2_row["_size"]:
            k2_row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, _size=n * len(cols))
    if k2_row is None:
        raise AssertionError("the pipeline made no K2 call")
    k2_row.pop("_size")

    result = {"kernels": [
        dict(name="compact", route="cuda",
             source="arrow1_tpu_torch/csrc/compaction.cu",
             replaces="arrow1_tpu/kernels/compaction_v14.py:171",
             launches=launches["compact"], max_abs_err=k2_err,
             bound_by="bytes", **k2_row),
        dict(name="filter_project_flagship", route="cuda",
             source="arrow1_tpu_torch/csrc/fused_filter_project.cu",
             replaces="arrow1_tpu/kernels/compaction_v15.py:205",
             launches=launches["filter_project_flagship"],
             max_abs_err=k1_err, bound_by="bytes", library_ms=None,
             **k1_rows[0.5]),
    ]}
    print(card)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
