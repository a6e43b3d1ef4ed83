#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (arrow1_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout:

    python3 chip_smoke.py

It builds every CUDA kernel from arrow1_tpu_torch/csrc (one nvcc per
library, all at once: one per ctypes source, and the operator library of
probe_ops.cu and probe_ops.cpp), then:

1. prints the card's name and power limit (nvidia-smi) and the build time;
2. holds the compaction kernel (K2) against its plain PyTorch version,
   bit for bit, at n in {1, 1000, 4097, 10M} and selectivities
   {0, 0.01, 0.5, 0.99, 1} over mixed i64/f64/i32/f32/bool columns and a
   validity stream, and times kernel, plain version and library call
   (boolean-mask indexing per column) with CUDA events;
3. holds the fused filter+project kernel (K1) against its plain version
   at 10M rows of bench.py's data recipe, selectivities 0.01, 0.25, 0.5
   and 0.99, and on a view one row in (8 bytes off 16-byte alignment),
   and times each with its share of the HBM bound;
4. drives the main path through the entry points a user calls: the
   entry pipeline (filter -> project -> group_by -> sort, materialized)
   at 10M rows with 1K groups and with ~1M groups (max_groups = 2^20, the
   K2 segment path), and the fused flagship at 10M rows. Every launch
   count is set to 0 just before and read just after; each kernel must
   have launched. The pipeline results must equal an independent numpy
   oracle. The K2 calls the pipeline made are captured in a separate,
   uncounted run and replayed against the plain version and timed;
5. holds the group accumulators against their plain versions at 10M
   rows: K3 (segment_sums) bit for bit over a live-masked int64 column
   with 10% nulls, an unmasked int64 column and 5% dead rows, at G = 1024
   (every CTA holds all groups), the first G past one CTA's shared memory
   (a two-CTA cluster shares them), 100096 (the group_by phase's padded
   G) and 131072 (an eight-CTA cluster shares them), at G = 1024 with
   every row in one group, and at G = 131072 over three masked columns
   and the unmasked one (four count slots: no cluster holds them, so rows
   add straight into the output with global atomics); each must be in its
   regime, and prints it with bytes/s and share of the bound; segsum
   v1 (segment_sum_count) at G = 4096 with exact counts and sums within
   1e-5 of each group's sum of |v| of a float64 index_add_ (the plain
   version is held to the same bound). Kernel, plain version and library
   call (torch.bincount and one index_add_ per output) are timed;
6. drives the eager group_by at BASELINE config 2, 10M rows, seed 0 (k in
   [0, G), v int64, w int32 with 10% nulls): sum/mean/count/sum at
   G = 1000 and 100000 on the dense-key path (one K3 launch each) and
   sum/count/min/max at G = 2^20 on the sorted path (no K3). Every launch
   count is set to 0 just before and read just after: K3 must have
   launched exactly twice. Each result must equal a numpy oracle in the
   path's row order (key order, first-appearance order). Then grouped
   float sums: a small input of float faults (a magnitude, inf, NaN and
   all-NaN groups) through the eager group_by, the hash_* entry points,
   the compiled pipeline and a two-batch query() must give pyarrow's
   answers, and 10M float64 rows at G = 1000 and 2^20 through the eager
   group_by and the compiled pipeline (sum, mean, variance) must give the
   same bits twice and sums within the summation bound of numpy's, with
   each wall;
7. drives the small sorted-build probe (K4, broadcast_probe) through its
   entry point at benchmarks/r2's shapes (seed 6, 9,994,240 probes in
   [0, 2^40), T in {256, 1024, 2048}) and on a second probe set (half the
   probes drawn from a build with duplicate runs, keys above 2^63), with
   its launch count set to 0 before and read after; holds it bit for bit
   against its plain version, the port's sort-merge probe (lo, counts)
   and the hash-table probe's counts, and times kernel, plain version and
   library call (two torch.searchsorted);
8. drives the eager join at BASELINE config 4 at full size (100M probe
   rows x 10M build rows, benchmarks/r5's recipe, seed 42): inner and
   left outer over uniform and skewed probe keys. Each leg must match a
   numpy bincount oracle in row count, mod-2^64 checksum and null rows,
   and, in the full output, row for row over probe rows [0, 1M) and over
   1M probe rows across the first hash-probe chunk boundary; prints the
   wall time (median of 3), the peak device memory and the least-bytes
   bound;
9. drives TPC-H Q3 at SF1 cardinalities (6,001,215 line items, 1.5M
   orders): filter, join on the order key, group by order priority, sum
   and count, sorted by the sum, eagerly and through the compiled
   pipeline; both must match a numpy oracle (counts exact, sums within
   Q3_RTOL relative);
10. drives compact_u64 and compact_split (the ports of the JAX package's
   last two compaction kernels) through their entry points at 9,999,360
   rows of (i64, i64, f64 bit view) columns, selectivities 0.5, 0 and 1,
   and at 1024 rows all kept, with their launch counts set to 0 before
   and read after; holds each bit for bit against its plain version and
   against K2 over [0, count), with outputs n + 1024 long, and times both
   beside K2 (compact_split's kernels A and B also alone), the plain
   versions and boolean-mask indexing;
11. runs the probe matrix (kernels/probes.py) on the card: every probe
   must read OK (its kernel launched once and equals its plain version);
   blocked-1d, blocked-2d, cumsum-1d and smem-output go through their
   PyTorch operators (torch.ops.a1t), the other two through ctypes. Each
   probe's kernel and, where one PyTorch call computes the same output,
   library call are timed in turns (CUDA events, median of PROBE_RUNS),
   the plain version alone, and each with its host time per call
   (HOST_CALLS back-to-back calls, one synchronise);
12. drives the query layer at TPC-H SF10 cardinalities (59,986,052 line
   items in 2^20-row batches, 15M orders, 1.5M customers): Q1, Q3, Q5 and
   Q6 through query() (models.tpch), Q1 as an acero Declaration and Q3
   through an ExecPlan with a JoinNode, each against a numpy oracle
   (integers and counts exact, float64 sums within SF10_RTOL relative),
   the acero and plan results equal to query()'s; prints each query's
   wall time (median of 3), peak device memory, least-bytes bound, and
   the K2, K3 and hash-join calls of one run;
13. drives BASELINE config 3 through models.baseline_sort: 100M rows on
   (dictionary string ascending, int64 with 1% nulls descending); checks
   on the card that the output is a permutation of the input rows,
   sorted, and stable; prints the wall time (median of 3) and peak
   device memory;
14. takes each probe's and library call's device time per call from
   torch.profiler's kernel records (PROFILE_CALLS calls), last, because
   the profiler's CUDA tracing may stay attached to the process and slow
   the launches after it; the operator probes must show their a1t::
   operator in the profile.

Every kernel wrapper of phases 3-10 also gets its host time per call
(HOST_CALLS back-to-back calls, one synchronise); where the card cannot
keep up, that is the card's time.

The line before the last is a JSON object with one entry per kernel
(time, bound, plain and library times, launches, error; each of the six
probes has its own entry); the last line is
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
PROBE_RUNS = 200      # event timings of the probes, whose medians move more
PROFILE_CALLS = 200   # calls under torch.profiler for device time per call
HOST_CALLS = 1000     # back-to-back calls for host time per call
K4_TS = (256, 1024, 2048)
K4_N = 10_000_000 // 16384 * 16384   # benchmarks/r2: 9,994,240 probes
JOIN_SLICE = 1_000_000               # probe rows checked row for row
JOIN_SCALE = 1                       # config 4 at full size
Q3_SCALE = 1                         # Q3 at SF1
# Q3's float64 sums: the engine and numpy's bincount add in different
# orders; at ~2M prices below 1000 with two decimals the rounding stays
# far below this
Q3_RTOL = 1e-9
SF10_RTOL = 1e-9     # the same bound for the SF10 queries' float64 sums
U64_N = 10_000_000 // 1024 * 1024    # 9,999,360 rows: 9,765 tiles of 1024
SF10_SCALE = 1       # TPC-H at SF10 cardinalities
SORT_ROWS = 100_000_000              # BASELINE config 3
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


def _host_us(fn, calls=HOST_CALLS) -> float:
    """Time per call, in us, of ``calls`` back-to-back calls with one
    synchronise at the end (after a warm-up): the host's cost of a call
    where the card keeps up with it, the card's time where it does not."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _us_text(us) -> str:
    return "not measured" if us is None else f"{us:.3f} us"


def _device_us(fn, calls=PROFILE_CALLS):
    """(device time per call in us, names of the kernels, names of the
    operators called) from torch.profiler's records over ``calls`` calls
    after a warm-up; the time is None when the profiler recorded no
    device time, or fewer records of a kernel than calls."""
    from arrow1_tpu_torch.profile_main_path import event_device_us

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    ops = {e.key for e in averages}
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and event_device_us(e) > 0]
    # a kernel with fewer records than calls lost some: no time from it
    if not kernels or min(e.count for e in kernels) < calls:
        return None, sorted({e.key[:60] for e in kernels}), ops
    return (sum(event_device_us(e) for e in kernels) / calls,
            sorted({e.key[:60] for e in kernels}), ops)


def _time_pair_ms(fn_a, fn_b, runs=PROBE_RUNS, warmup=3):
    """Medians of per-call CUDA-event times of two functions called in
    turns (a b, b a, a b, ...), so that both meet the same host."""
    for _ in range(warmup):
        fn_a()
        fn_b()
    torch.cuda.synchronize()
    ev = {fn: [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
          for fn in (fn_a, fn_b)}
    for i in range(runs):
        for fn in ((fn_a, fn_b) if i % 2 == 0 else (fn_b, fn_a)):
            start, end = ev[fn][i]
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize()
    return tuple(statistics.median(s.elapsed_time(e) for s, e in ev[fn])
                 for fn in (fn_a, fn_b))


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
    plain_ms = _time_ms(lambda: compact_plain(mask, cols))
    lib_ms = _time_ms(lambda: [c[mask] for c in cols])
    bound = _compact_bytes(N_BIG, cols, k) / peak * 1e3
    print(f"K2 compact 10M x (i64,i64,f64) sel 0.5: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, mask indexing {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({bound / ms:.1%} of the HBM bound)", flush=True)
    return err


def _flagship_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 20, n).astype(np.int64),
            rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            rng.standard_normal(n))


def _vthr(sel):
    """bench.py: with f > 0 keeping half, P(v > vthr) = 2*sel."""
    return int((1.0 - 2.0 * min(2.0 * sel, 1.0)) * (1 << 30))


def _predicate(sel, f_host):
    """(thresh, vthr) keeping a share ``sel`` of the flagship rows:
    bench.py's recipe up to 0.5, above it f's (1 - sel) quantile with
    every v kept."""
    if sel <= 0.5:
        return 0.0, _vthr(sel)
    return float(np.quantile(f_host, 1.0 - sel)), -(1 << 30) - 1


def _check_fused(fused, key, v, f, thresh, vthr, label):
    ko, po, c = fused.filter_project_flagship(key, v, f, thresh, vthr)
    pk, pp, pc = fused.filter_project_plain(key, v, f, thresh, vthr)
    k = int(pc)
    if int(c) != k or not torch.equal(ko[:k], pk[:k]) or \
            not torch.equal(_bits(po[:k]), _bits(pp[:k])):
        raise AssertionError(f"K1 differs from plain ({label})")
    return k, max(_max_abs_err(ko[:k], pk[:k]), _max_abs_err(po[:k], pp[:k]))


def phase_fused(fused, dev, peak):
    host_data = _flagship_data(N_BIG)
    key, v, f = (torch.from_numpy(a).to(dev) for a in host_data)
    err = 0.0
    rows = {}
    for sel in (0.01, 0.25, 0.5, 0.99):
        thresh, vthr = _predicate(sel, host_data[2])
        k, e = _check_fused(fused, key, v, f, thresh, vthr, f"sel {sel}")
        err = max(err, e)
        ms = _time_ms(lambda: fused.filter_project_flagship(
            key, v, f, thresh, vthr))
        plain_ms = _time_ms(lambda: fused.filter_project_plain(
            key, v, f, thresh, vthr))
        nbytes = N_BIG * 24 + k * 16   # read key, v, f; write kept rows
        bound = nbytes / peak * 1e3
        print(f"K1 flagship 10M sel {sel} (kept {k}): bit-equal; kernel "
              f"{ms:.4f} ms = {N_BIG / ms * 1e3:.4g} rows/s, "
              f"{nbytes / ms * 1e3:.4g} B/s = {bound / ms:.1%} of HBM "
              f"(bound {bound:.4f} ms); plain {plain_ms:.4f} ms",
              flush=True)
        host = _host_us(lambda: fused.filter_project_flagship(
            key, v, f, thresh, vthr))
        print(f"K1 flagship 10M sel {sel}: host {host:.2f} us per call "
              f"({HOST_CALLS} back to back)", flush=True)
        rows[sel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         host_us=host)
    # a view one row in: 8 bytes off the 16-byte alignment of the copies
    views = (key[1:], v[1:], f[1:])
    thresh, vthr = _predicate(0.5, host_data[2])
    k, e = _check_fused(fused, *views, thresh, vthr, "misaligned view")
    err = max(err, e)
    ms = _time_ms(lambda: fused.filter_project_flagship(*views, thresh,
                                                        vthr))
    bound = ((N_BIG - 1) * 24 + k * 16) / peak * 1e3
    print(f"K1 flagship 10M - 1 rows, a view one row in (address % 16 = "
          f"{views[0].data_ptr() % 16}), sel 0.5: bit-equal; kernel "
          f"{ms:.4f} ms = {bound / ms:.1%} of HBM", flush=True)
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


def _int_err(a, b) -> float:
    """Max |a - b| of two int64 tensors (wrapping difference)."""
    return float((a - b).abs().max()) if a.numel() else 0.0


def _k3_inputs(n, G, dev, seed, masked=1):
    """gid with 5% dead rows (gid == G), `masked` live-masked int64
    columns with 10% nulls and an unmasked int64 column."""
    rng = np.random.default_rng(seed)
    gid = np.where(rng.random(n) < 0.05, G,
                   rng.integers(0, G, n)).astype(np.int32)
    a = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    live = rng.random(n) >= 0.1
    b = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    t = [torch.from_numpy(x).to(dev) for x in (gid, a, live, b)]
    cols = [(t[1], t[2])]
    for _ in range(masked - 1):
        x = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
        m = rng.random(n) >= 0.1
        cols.append((torch.from_numpy(x).to(dev),
                     torch.from_numpy(m).to(dev)))
    return t[0], cols + [(t[3], None)]


def _k3_library(gid, cols, G):
    """One PyTorch call per output: bincount for the occupancy, one
    index_add_ per live count and per sum (inputs prepared outside)."""
    idx = torch.where(gid < G, gid, G).long()
    prepared = []
    for vals, live in cols:
        if live is not None:
            prepared.append(live.long())
        prepared.append(vals if live is None else torch.where(live, vals, 0))

    def run():
        out = [torch.bincount(idx, minlength=G + 1)]
        for src in prepared:
            out.append(torch.zeros(G + 1, dtype=torch.int64,
                                   device=gid.device).index_add_(0, idx, src))
        return out

    return run


def _check_k3(segsum2, gid, cols, G, label):
    occ, res = segsum2.segment_sums(gid, cols, G)
    occ_p, res_p = segsum2.segment_sums_plain(gid, cols, G)
    if not torch.equal(occ, occ_p):
        raise AssertionError(f"K3 occupancy differs from plain, {label}")
    err = _int_err(occ, occ_p)
    for (c, s), (cp, sp) in zip(res, res_p):
        if not torch.equal(c, cp) or (s is None) != (sp is None) or \
                (s is not None and not torch.equal(s, sp)):
            raise AssertionError(f"K3 differs from plain, {label}")
        err = max(err, _int_err(c, cp), 0.0 if s is None else _int_err(s, sp))
    return err


def phase_segment_sums(segsum2, dev, peak):
    """K3 against its plain version at 10M rows, in each regime; returns
    (error, the G = 1024 row, the main path's)."""
    err, row = 0.0, None
    smem = segsum2._kernel()[1]
    past_one_cta = smem // 24 + 1   # 2 count + 2 sum slots: 24 B a group
    # (G, every row in one group, masked columns, the regime it must take)
    for G, hot, masked, regime in ((1024, False, 1, "private"),
                                   (past_one_cta, False, 1, "owned"),
                                   (100_096, False, 1, "owned"),
                                   (131_072, False, 1, "owned"),
                                   (1024, True, 1, "private"),
                                   (131_072, False, 3, "global")):
        gid, cols = _k3_inputs(N_BIG, G, dev, seed=G, masked=masked)
        if hot:   # every live row in one group
            gid = torch.where(gid < G, 7, gid).to(torch.int32)
        label = (f"G={G}{' one hot group' if hot else ''}"
                 f"{f', {masked} masked columns' if masked > 1 else ''}")
        err = max(err, _check_k3(segsum2, gid, cols, G, label))
        slots = 1 + sum((m is not None) + (v is not None) for v, m in cols)
        p = segsum2.plan(G, slots - sum(v is not None for v, _ in cols),
                         sum(v is not None for v, _ in cols), smem)
        if p.mode != regime:
            raise AssertionError(f"K3 {label}: regime {p.mode}, expected "
                                 f"{regime}")
        ms = _time_ms(lambda: segsum2.segment_sums(gid, cols, G))
        plain_ms = _time_ms(lambda: segsum2.segment_sums_plain(gid, cols, G))
        lib_ms = _time_ms(_k3_library(gid, cols, G))
        nbytes = N_BIG * (4 + sum(8 * (v is not None) + (m is not None)
                                  for v, m in cols)) + G * 8 * slots
        bound = nbytes / peak * 1e3
        print(f"K3 segment_sums 10M rows, {label}, {slots} slots, regime "
              f"{p.mode} (cluster {p.cluster}): bit-equal to plain; kernel "
              f"{ms:.4f} ms = {nbytes / ms * 1e3:.4g} B/s = "
              f"{bound / ms:.1%} of the HBM bound ({bound:.4f} ms); plain "
              f"{plain_ms:.4f} ms, bincount+index_add_ {lib_ms:.4f} ms",
              flush=True)
        if G in (1024, 131_072) and not hot and masked == 1:
            host = _host_us(lambda: segsum2.segment_sums(gid, cols, G))
            print(f"K3 segment_sums {label}: host {host:.2f} us per call "
                  f"({HOST_CALLS} back to back)", flush=True)
            if G == 1024:
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, host_us=host)
    return err, row


def phase_segment_sum_count(segsum, dev, peak):
    """segsum v1 against its plain version at 10M rows, G = 4096."""
    G = 4096
    rng = np.random.default_rng(1)
    gid = torch.from_numpy(np.where(rng.random(N_BIG) < 0.05, G,
                                    rng.integers(0, G, N_BIG)).astype(
        np.int32)).to(dev)
    val = torch.from_numpy(rng.standard_normal(N_BIG).astype(
        np.float32)).to(dev)
    live = torch.from_numpy(rng.random(N_BIG) >= 0.1).to(dev)
    s, c = segsum.segment_sum_count(gid, val, live, G)
    sp, cp = segsum.segment_sum_count_plain(gid, val, live, G)
    keep = live & (gid < G)
    idx = torch.where(keep, gid, G).long()
    ref = torch.zeros(G + 1, dtype=torch.float64, device=dev).index_add_(
        0, idx, torch.where(keep, val, 0.0).double())[:G]
    abs_sum = torch.zeros(G + 1, dtype=torch.float64, device=dev).index_add_(
        0, idx, torch.where(keep, val.abs(), 0.0).double())[:G]
    if not torch.equal(c, cp):
        raise AssertionError("v1 counts differ from plain")
    for label, got in (("kernel", s), ("plain", sp)):
        if not bool(((got.double() - ref).abs() <= 1e-5 * abs_sum).all()):
            raise AssertionError(f"v1 {label} sums outside 1e-5 * sum|v| "
                                 "of the float64 reference")
    err = _max_abs_err(s, sp)
    ms = _time_ms(lambda: segsum.segment_sum_count(gid, val, live, G))
    plain_ms = _time_ms(lambda: segsum.segment_sum_count_plain(gid, val,
                                                               live, G))
    masked = torch.where(keep, val, 0.0)

    def library():
        return (torch.zeros(G + 1, dtype=torch.float32,
                            device=dev).index_add_(0, idx, masked),
                torch.bincount(idx, minlength=G + 1))

    lib_ms = _time_ms(library)
    nbytes = N_BIG * (4 + 4 + 1) + G * 4 * 2
    bound = nbytes / peak * 1e3
    print(f"v1 segment_sum_count 10M rows, G={G}: counts exact, sums "
          f"within 1e-5 * sum|v| (max |kernel - plain| {err:.3g}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_+bincount "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%} of the "
          "HBM bound)", flush=True)
    host = _host_us(lambda: segsum.segment_sum_count(gid, val, live, G))
    print(f"v1 segment_sum_count G={G}: host {host:.2f} us per call "
          f"({HOST_CALLS} back to back)", flush=True)
    return err, dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound, host_us=host)


DENSE_AGGS = [("v", "sum"), ("v", "mean"), ("w", "count"), ("w", "sum")]
SORTED_AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")]


def _group_by_data(G):
    """BASELINE config 2 at 10M rows, seed 0: k in [0, G), v int64, w
    int32 with 10% nulls."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, G, N_BIG).astype(np.int64)
    v = rng.integers(-(1 << 30), 1 << 30, N_BIG).astype(np.int64)
    w = rng.integers(-(1 << 20), 1 << 20, N_BIG).astype(np.int32)
    w_valid = rng.random(N_BIG) >= 0.1
    return k, v, w, w_valid


def _group_by_oracle(k, v, w, w_valid, G, dense):
    """Independent numpy answer, groups in the path's order: key order on
    the dense path, first appearance on the sorted one. Sums wrap as
    uint64 and are read back as int64."""
    uniq, first, inv = np.unique(k, return_index=True, return_inverse=True)
    order = np.arange(len(uniq)) if dense else np.argsort(first)
    out = {"k": uniq[order]}
    ng = len(uniq)

    def wrapped_sum(idx, x):
        acc = np.zeros(ng, np.uint64)
        np.add.at(acc, idx, x.astype(np.int64).view(np.uint64))
        return acc.view(np.int64)

    v_count = np.bincount(inv, minlength=ng)
    v_sum = wrapped_sum(inv, v)
    if dense:
        out["v_sum"] = v_sum[order]
        out["v_mean"] = (v_sum.astype(np.float64) / v_count)[order]
        w_count = np.bincount(inv[w_valid], minlength=ng)[order]
        out["w_count"] = w_count
        # a group whose w are all null sums to null
        out["w_sum"] = (wrapped_sum(inv[w_valid], w[w_valid])[order],
                        w_count > 0)
    else:
        v_min = np.full(ng, np.iinfo(np.int64).max)
        v_max = np.full(ng, np.iinfo(np.int64).min)
        np.minimum.at(v_min, inv, v)
        np.maximum.at(v_max, inv, v)
        out.update(v_sum=v_sum[order], v_count=v_count[order],
                   v_min=v_min[order], v_max=v_max[order])
    return out


def _check_group_by(out, want, label):
    if out.num_rows != len(want["k"]):
        raise AssertionError(f"group_by {label}: {out.num_rows} groups, "
                             f"oracle {len(want['k'])}")
    for name, ref in want.items():
        ref, valid = ref if isinstance(ref, tuple) else \
            (ref, np.ones(len(ref), bool))
        col = out[name]
        got_valid = np.ones(len(ref), bool) if col.validity is None else \
            col.validity.cpu().numpy()
        got = col.data.cpu().numpy()
        if not np.array_equal(got_valid, valid) or \
                not np.array_equal(got[valid], ref[valid]):
            raise AssertionError(f"group_by {label}: column {name} differs "
                                 "from the numpy oracle")


def phase_group_by(pt, dev, counted):
    """The eager group_by at BASELINE config 2; returns the launch counts
    of the counted run."""
    configs = []
    for label, G, aggs, dense in (("G=1000", 1000, DENSE_AGGS, True),
                                  ("G=100000", 100_000, DENSE_AGGS, True),
                                  ("G=2^20", 1 << 20, SORTED_AGGS, False)):
        k, v, w, w_valid = _group_by_data(G)
        batch = pt.record_batch({"k": k, "v": v}, device=dev)
        wcol = pt.Column(torch.from_numpy(w).to(dev), pt.int32,
                         validity=torch.from_numpy(w_valid).to(dev))
        batch = pt.RecordBatch(batch.columns + (wcol,), batch.names + ("w",))
        configs.append((label, batch, aggs,
                        _group_by_oracle(k, v, w, w_valid, G, dense)))
    for label, batch, aggs, want in configs:   # uncounted warm-up run
        _check_group_by(pt.group_by(batch, ["k"], aggs), want, label)
    torch.cuda.synchronize()
    for kern in counted:
        kern.launches = 0
    for label, batch, aggs, want in configs:
        _check_group_by(pt.group_by(batch, ["k"], aggs), want, label)
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in counted}
    for label, batch, aggs, want in configs:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pt.group_by(batch, ["k"], aggs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"group_by 10M rows, {label} {[f for _, f in aggs]}: matches "
              f"the numpy oracle; wall {statistics.median(walls) * 1e3:.3f} "
              "ms (median of 3)", flush=True)
    return launches


NAN, INF = float("nan"), float("inf")
# The grouped-float fault input (tests/test_torch_port_faults.py holds
# FLOAT_WANT to be pyarrow's answer): groups 1-9 in key order. A cumsum
# differenced across groups loses group 2's 3.0 under group 1's 2e20, and
# group 3's inf and group 5's NaN reach every later group; group 5 is all
# NaN, group 7 holds one NaN beside 4.0, group 9 only nulls.
FLOAT_K = [1, 2, 2, 1, 3, 4, 4, 3, 5, 6, 6, 5, 7, 8, 8, 7, 2, 9]
FLOAT_V = [1e20, 1.0, 2.0, 1e20, INF, 5.0, 5.0, INF, NAN, 3.0, 3.0, NAN,
           NAN, 7.0, 1.0, 4.0, None, None]
FLOAT_AGGS = [("v", "sum"), ("v", "mean"), ("v", "variance"),
              ("v", "stddev"), ("v", "min"), ("v", "max")]
FLOAT_WANT = {
    "v_sum": [2e20, 3.0, INF, 10.0, NAN, 6.0, NAN, 8.0, None],
    "v_mean": [1e20, 1.5, INF, 5.0, NAN, 3.0, NAN, 4.0, None],
    "v_variance": [0.0, 0.25, NAN, 0.0, NAN, 0.0, NAN, 9.0, None],
    "v_stddev": [0.0, 0.5, NAN, 0.0, NAN, 0.0, NAN, 3.0, None],
    "v_min": [1e20, 1.0, INF, 5.0, NAN, 3.0, 4.0, 1.0, None],
    "v_max": [1e20, 2.0, INF, 5.0, NAN, 3.0, 4.0, 7.0, None],
}
FLOAT_SUM_AGGS = [("f", "sum"), ("f", "mean"), ("f", "variance")]


def _same_floats(got, want) -> bool:
    """Equal lists of floats and None, NaN equal to NaN."""
    return len(got) == len(want) and all(
        a == b or (a is not None and b is not None and a != a and b != b)
        for a, b in zip(got, want))


def _key_order(out, names, key="k"):
    order = np.argsort(out[key].data.cpu().numpy(), kind="stable")
    return {n: [out[n].to_pylist()[i] for i in order] for n in names}


def _check_float_faults(pt, dev):
    """The fault input through the eager group_by, the hash_* entry
    points, the compiled pipeline and a two-batch query() on the card."""
    v = np.array([NAN if x is None else x for x in FLOAT_V])
    b = pt.record_batch({"k": np.array(FLOAT_K, np.int64), "v": v,
                         "g": np.array(FLOAT_K, np.int32) - 1}, device=dev)
    vcol = pt.Column(b["v"].data, b["v"].dtype, validity=torch.tensor(
        [x is not None for x in FLOAT_V], device=dev))
    b = pt.RecordBatch((b["k"], vcol, b["g"]), b.names)
    names = [f"v_{f}" for _, f in FLOAT_AGGS]
    pipe = pt.PipelineBuilder().group_by(["k"], FLOAT_AGGS).compile()
    results = {"group_by": _key_order(pt.group_by(b, ["k"], FLOAT_AGGS),
                                      names),
               "compiled pipeline": _key_order(pipe(b), names),
               "hash_*": {f"v_{f}": pt.call_function(
                   f"hash_{f}", [b["v"], b["g"]]).to_pylist()
                   for _, f in FLOAT_AGGS},
               "two-batch query()": _key_order(
                   pt.query(pt.Table([b.slice(0, 9), b.slice(9, 9)]))
                   .group_by(["k"], FLOAT_AGGS[:2] + FLOAT_AGGS[4:])
                   .to_batch(), ["v_sum", "v_mean", "v_min", "v_max"])}
    for label, got in results.items():
        for name, values in got.items():
            if not _same_floats(values, FLOAT_WANT[name]):
                raise AssertionError(f"float faults, {label}: {name} = "
                                     f"{values}, pyarrow "
                                     f"{FLOAT_WANT[name]}")
    print(f"grouped float faults on the card: {', '.join(results)} give "
          "pyarrow's answers", flush=True)


def phase_float_sums(pt, dev):
    """Grouped float sums on the card: the fault input, then 10M rows of
    float64 at G = 1000 and 2^20 through the eager group_by and the
    compiled pipeline, run twice (the same bits), each sum within the
    summation bound of numpy's row-order sum (any order of n_g additions
    is within (n_g - 1) u sum|f| of the exact sum, u = 2^-53, so two
    orders differ by at most twice that), and each wall timed."""
    _check_float_faults(pt, dev)
    rng = np.random.default_rng(4)
    for G, max_groups in ((1000, 65536), (1 << 20, 1 << 20)):
        k = rng.integers(0, G, N_BIG).astype(np.int64)
        f = rng.standard_normal(N_BIG) * 10.0 ** rng.integers(-3, 4, N_BIG)
        batch = pt.record_batch({"k": k, "f": f}, device=dev)
        count = np.bincount(k, minlength=G)
        want = np.bincount(k, f, minlength=G)
        scale = 2.0 ** -53 * np.bincount(k, np.abs(f), minlength=G)
        bound = 2 * np.maximum(count - 1, 0) * scale
        pipe = pt.PipelineBuilder().group_by(
            ["k"], FLOAT_SUM_AGGS, max_groups=max_groups).compile()
        for label, run in (("group_by", lambda: pt.group_by(
                batch, ["k"], FLOAT_SUM_AGGS)), ("pipeline", lambda: pipe(
                    batch))):
            first, second = run(), run()
            for name in ("k", "f_sum", "f_mean", "f_variance"):
                if not torch.equal(_bits(first[name].data),
                                   _bits(second[name].data)):
                    raise AssertionError(f"float sums, {label} G={G}: "
                                         f"{name} differs between runs")
            keys = first["k"].data.cpu().numpy()
            got = first["f_sum"].data.cpu().numpy()
            err = np.abs(got - want[keys])
            if len(keys) != int((count > 0).sum()) or \
                    not np.all(err <= bound[keys]):
                raise AssertionError(f"float sums, {label} G={G}: outside "
                                     "the summation bound of numpy's sum")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            ulps = float((err / np.maximum(scale[keys], 1e-300)).max())
            print(f"float sums, {label} 10M rows, G={G} {FLOAT_SUM_AGGS}: "
                  f"two runs bit-identical; |sum - numpy's| at most {ulps:.1f}"
                  " u sum|f| (bound 2 (n_g - 1)); wall "
                  f"{statistics.median(walls) * 1e3:.3f} ms (median of 3)",
                  flush=True)


def _k4_sets(dev):
    """benchmarks/r2/measure_r2.py op_broadcast's recipe (seed 6), and a
    second set per T (seed 7): a build of T keys drawn with repeats from
    T/4 keys over the whole u64 range (so half lie above 2^63), probes
    half drawn from the build. Keys are int64 bit patterns."""
    rng = np.random.default_rng(6)
    sets = []
    for T in K4_TS:
        build = np.sort(rng.integers(0, 1 << 40, T).astype(np.uint64))
        probe = rng.integers(0, 1 << 40, K4_N).astype(np.uint64)
        sets.append((f"r2 T={T}", T, build, probe))
    rng = np.random.default_rng(7)
    for T in K4_TS:
        distinct = rng.integers(0, 1 << 64, T // 4, dtype=np.uint64)
        build = np.sort(rng.choice(distinct, T))
        probe = np.concatenate([
            rng.choice(build, K4_N // 2),
            rng.integers(0, 1 << 64, K4_N - K4_N // 2, dtype=np.uint64)])
        rng.shuffle(probe)
        sets.append((f"duplicates, high keys, T={T}", T, build, probe))
    return [(label, T, torch.from_numpy(b.view(np.int64)).to(dev),
             torch.from_numpy(p.view(np.int64)).to(dev))
            for label, T, b, p in sets]


def phase_broadcast_probe(pt, ht, padded, dev, peak, counted):
    """K4 through its entry point (counted), then against its plain
    version and the join's probes, and timed. Returns (launches, error,
    row of the T = 2048 r2 shape)."""
    from arrow1_tpu_torch.ops.join import _hash_probe_ranges

    sets = _k4_sets(dev)
    torch.cuda.synchronize()
    for kern in counted:
        kern.launches = 0
    results = [pt.broadcast_probe(build, probe)
               for _, _, build, probe in sets]
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in counted}
    if launches["broadcast_probe"] != len(sets):
        raise AssertionError(f"K4 launched {launches['broadcast_probe']} "
                             f"times for {len(sets)} probe sets")
    err, row = 0.0, None
    for (label, T, build, probe), (lo, cnt) in zip(sets, results):
        plo, pcnt = ht.broadcast_probe_plain(build, probe)
        if not (torch.equal(lo, plo) and torch.equal(cnt, pcnt)):
            raise AssertionError(f"K4 differs from its plain version "
                                 f"({label})")
        err = max(err, _int_err(lo.long(), plo.long()),
                  _int_err(cnt.long(), pcnt.long()))
        order, slo, scnt = padded.probe_ranges_sortmerge(probe, build)
        if not (torch.equal(order, torch.arange(T, device=dev))
                and torch.equal(lo.long(), slo) and torch.equal(cnt, scnt)):
            raise AssertionError(f"K4 differs from the sort-merge probe "
                                 f"({label})")
        if not torch.equal(cnt, _hash_probe_ranges(probe, build, None)[2]):
            raise AssertionError(f"K4 counts differ from the hash-table "
                                 f"probe ({label})")
        line = (f"K4 broadcast_probe {K4_N} probes, {label}: bit-equal to "
                "plain, sort-merge and hash probes")
        if label.startswith("r2"):
            ms = _time_ms(lambda: ht.broadcast_probe(build, probe))
            plain_ms = _time_ms(lambda: ht.broadcast_probe_plain(build,
                                                                  probe))
            bf, pf = build ^ (-(1 << 63)), probe ^ (-(1 << 63))
            lib_ms = _time_ms(lambda: (
                torch.searchsorted(bf, pf, side="left"),
                torch.searchsorted(bf, pf, side="right")))
            bound = (K4_N * 16 + T * 8) / peak * 1e3
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"searchsorted x2 {lib_ms:.4f} ms, bound {bound:.4f} "
                     f"ms ({bound / ms:.1%} of the HBM bound)")
            if T == 2048:
                host = _host_us(lambda: ht.broadcast_probe(build, probe))
                line += f"; host {host:.2f} us per call"
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, host_us=host)
        print(line, flush=True)
    return launches, err, row


def _join_oracle(pk, pv, bk, bw, outer):
    """measure_r5's oracle: output rows, sum of pv*bw over matched rows
    (mod 2^64), rows with a null build side and the sum of their pv, from
    per-key bincounts. Per-key sums stay below 2^53, so float64 weights
    are exact."""
    dom = int(max(pk.max(), bk.max())) + 1
    cnt_b = np.bincount(bk, minlength=dom)
    cnt_p = np.bincount(pk, minlength=dom)
    sum_bw = np.bincount(bk, weights=bw.astype(np.float64),
                         minlength=dom).astype(np.int64)
    sum_pv = np.bincount(pk, weights=pv.astype(np.float64),
                         minlength=dom).astype(np.int64)
    with np.errstate(over="ignore"):
        total = int((cnt_p * cnt_b).sum())
        checksum = np.int64((sum_pv * sum_bw).sum())
        n_null, null_pv = 0, np.int64(0)
        if outer:
            unmatched = cnt_b == 0
            n_null = int(cnt_p[unmatched].sum())
            null_pv = np.int64(sum_pv[unmatched].sum())
            total += n_null
    return total, int(checksum), n_null, int(null_pv)


def _join_oracle_rows(pk, pv, bk, bw, outer, a, b):
    """Row-exact output for probe rows [a, b): probe order, each probe's
    matches in build order. Returns the window's first output row and
    its (k, pv, bw, bw valid)."""
    order = np.argsort(bk, kind="stable")
    bks = bk[order]
    cnt_b = np.bincount(bk, minlength=int(pk[:a].max(initial=0)) + 1)
    emit_before = cnt_b[pk[:a]]
    if outer:
        emit_before = np.maximum(emit_before, 1)
    p, v = pk[a:b], pv[a:b]
    ls = np.searchsorted(bks, p, side="left")
    cnt = np.searchsorted(bks, p, side="right") - ls
    emit = np.maximum(cnt, 1) if outer else cnt
    rows = np.repeat(np.arange(len(p)), emit)
    within = np.arange(len(rows)) - (np.cumsum(emit) - emit)[rows]
    has = cnt[rows] > 0
    bidx = order[np.clip(ls[rows] + within, 0, len(bk) - 1)]
    return (int(emit_before.sum()),
            (p[rows], v[rows], np.where(has, bw[bidx], 0), has))


def _join_sums(out):
    """(rows, checksum, null rows, sum of pv over null rows) on the
    card, int64 sums wrapping mod 2^64."""
    opv, obw = out["pv"].data, out["bw"].data
    valid = out["bw"].mask()
    return (out.num_rows, int(torch.where(valid, opv * obw, 0).sum()),
            int((~valid).sum()), int(torch.where(valid, 0, opv).sum()))


def _join_windows(n):
    """Probe-row windows checked row for row: the first JOIN_SLICE rows,
    and JOIN_SLICE rows across the first hash-probe chunk boundary
    (where the chunks' outputs are concatenated) when there is one."""
    from arrow1_tpu_torch.kernels.hashtable import PROBE_CHUNK

    wins = [(0, min(JOIN_SLICE, n))]
    if PROBE_CHUNK < n:
        a = max(PROBE_CHUNK - JOIN_SLICE // 2, 0)
        wins.append((a, min(a + JOIN_SLICE, n)))
    return wins


def _check_join_rows(out, pk, pv, bk, bw, outer, label):
    """The full output's rows of each window against the oracle's."""
    for a, b in _join_windows(len(pk)):
        start, (ek, epv, ebw, evalid) = _join_oracle_rows(
            pk, pv, bk, bw, outer, a, b)
        stop = start + len(ek)
        got = [out[c].data[start:stop].cpu().numpy()
               for c in ("k", "pv", "bw")]
        gvalid = out["bw"].mask()[start:stop].cpu().numpy()
        if not (len(got[0]) == len(ek) and np.array_equal(got[0], ek)
                and np.array_equal(got[1], epv)
                and np.array_equal(gvalid, evalid)
                and np.array_equal(got[2][gvalid], ebw[evalid])):
            raise AssertionError(f"join {label}: probe rows [{a}, {b}) "
                                 "differ from the oracle row for row")


def phase_join(pt, dev, peak, counted):
    """BASELINE config 4 at full size: four legs of the eager join.
    Returns the launch counts of the counted runs."""
    from arrow1_tpu_torch.profile_main_path import join_data

    launches = {kern.__name__: 0 for kern in counted}
    for kind in ("uniform", "skew"):
        pk, pv, bk, bw = join_data(kind, scale=JOIN_SCALE)
        probe = pt.record_batch({"k": pk, "pv": pv}, device=dev)
        build = pt.record_batch({"k": bk, "bw": bw}, device=dev)
        for jt in ("inner", "left outer"):
            outer = jt == "left outer"
            label = f"{jt} {kind}"
            want = _join_oracle(pk, pv, bk, bw, outer)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in counted:
                kern.launches = 0
            out = pt.join(probe, build, ["k"], join_type=jt)
            torch.cuda.synchronize()
            for kern in counted:
                launches[kern.__name__] += kern.launches
            mem = torch.cuda.max_memory_allocated()
            got = _join_sums(out)
            if got != want:
                raise AssertionError(f"join {label}: (rows, checksum, null "
                                     f"rows, null pv) {got} != oracle {want}")
            _check_join_rows(out, pk, pv, bk, bw, outer, label)
            del out
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pt.join(probe, build, ["k"], join_type=jt)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                del out
            nbytes = (len(pk) + len(bk)) * 16 + want[0] * (24 + outer)
            wall = statistics.median(walls) * 1e3
            wins = ", ".join(f"[{a}, {b})" for a, b in _join_windows(len(pk)))
            print(f"join {len(pk)} x {len(bk)}, {label}: {want[0]} rows, "
                  f"checksum and null rows match the oracle, probe rows "
                  f"{wins} match row for row; wall {wall:.3f} ms "
                  f"(median of 3), peak device memory "
                  f"{mem / 2**30:.2f} GiB, least-bytes bound "
                  f"{nbytes / peak * 1e3:.4f} ms ({nbytes / 1e9:.3f} GB)",
                  flush=True)
        del probe, build
    return launches


def _q3_oracle(li, orders, pm):
    """Numpy Q3: line items passing the filter, each joined to its order
    by key, grouped by priority; (priorities, sums, counts) sorted by the
    sum, descending."""
    keep = li["l_shipdate_days"] <= pm.Q3_SHIPDATE_MAX
    okeys = orders["o_orderkey"]
    pos = np.searchsorted(okeys, li["l_orderkey"][keep])
    if not np.array_equal(okeys[pos], li["l_orderkey"][keep]):
        raise AssertionError("Q3 data: a line item has no order")
    codes, pool = orders["o_orderpriority"]
    prio = codes[pos]
    sums = np.bincount(prio, weights=li["l_extendedprice"][keep],
                       minlength=len(pool))
    counts = np.bincount(prio, minlength=len(pool))
    order = np.argsort(-sums, kind="stable")
    order = order[counts[order] > 0]
    return pool[order], sums[order], counts[order]


def _check_q3(out, want, label):
    names, sums, counts = want
    got_names = out["o_orderpriority"].to_numpy()
    got_sums = out["l_extendedprice_sum"].data.cpu().numpy()
    got_counts = out["l_orderkey_count"].data.cpu().numpy()
    if not (got_names.tolist() == names.tolist()
            and np.array_equal(got_counts, counts)
            and np.allclose(got_sums, sums, rtol=Q3_RTOL, atol=0)):
        raise AssertionError(f"Q3 {label} differs from the numpy oracle: "
                             f"{got_names} {got_sums} {got_counts} vs "
                             f"{names} {sums} {counts}")


def phase_q3(pt, dev, counted):
    """TPC-H Q3 at SF1 cardinalities, eager and compiled. Returns the
    launch counts of the counted run."""
    import arrow1_tpu_torch.profile_main_path as pm

    li, orders = pm.q3_data(pm.Q3_LINEITEM // Q3_SCALE,
                            pm.Q3_ORDERS // Q3_SCALE)
    want = _q3_oracle(li, orders, pm)
    lb, ob = pm.q3_batch(li, dev), pm.q3_batch(orders, dev)
    pipe = pm.q3_pipeline(ob)
    runs = (("eager", lambda: pm.q3_eager(lb, ob)),
            ("compiled", lambda: pipe(lb)))
    for label, fn in runs:   # uncounted warm-up run
        _check_q3(fn(), want, label)
    torch.cuda.synchronize()
    for kern in counted:
        kern.launches = 0
    outs = [fn() for _, fn in runs]
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in counted}
    if launches["compact"] <= 0:
        raise AssertionError("Q3 launched no K2")
    for (label, fn), out in zip(runs, outs):
        _check_q3(out, want, label)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"TPC-H Q3 SF1 ({li['l_orderkey'].shape[0]} line items, "
              f"{orders['o_orderkey'].shape[0]} orders), {label}: matches "
              f"the numpy oracle; wall {statistics.median(walls) * 1e3:.3f} "
              "ms (median of 3)", flush=True)
    return launches


def _u64_inputs(n, sel, dev, seed=0):
    """K2's 10M-row shape of PERF.md (i64 in [0, 2^20), i64 in
    [-2^30, 2^30), f64 normal draws as their int64 bit view) at n rows,
    with a mask of selectivity ``sel``."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 1 << 20, n).astype(np.int64),
            rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            rng.standard_normal(n).view(np.int64)]
    mask = rng.random(n) < sel
    return (torch.from_numpy(mask).to(dev),
            [torch.from_numpy(c).to(dev) for c in cols])


def _check_u64_kernel(fn, plain, compact, mask, cols, label):
    """Kernel vs plain version and vs K2 over [0, count); returns (error,
    count)."""
    outs, count = fn(mask, cols)
    pouts, pcount = plain(mask, cols)
    kouts, kcount = compact(mask, cols)
    k = int(pcount)
    if int(count) != k or int(kcount) != k:
        raise AssertionError(f"{label}: count {int(count)}, plain {k}, K2 "
                             f"{int(kcount)}")
    n = mask.shape[0]
    err = 0.0
    for o, p, r in zip(outs, pouts, kouts):
        if o.shape != (n + 1024,):
            raise AssertionError(f"{label}: output of {o.shape[0]} slots, "
                                 f"not n + 1024 = {n + 1024}")
        if not (torch.equal(o[:k], p[:k]) and torch.equal(o[:k], r[:k])):
            raise AssertionError(f"{label}: output differs from the plain "
                                 "version or from K2")
        err = max(err, _int_err(o[:k], p[:k]))
    return err, k


def phase_u64_compaction(pt_kernels, dev, peak):
    """compact_u64 and compact_split through their entry points (counted),
    against their plain versions and K2, and timed beside K2. Returns
    (launches, errors, rows)."""
    from arrow1_tpu_torch.kernels import compaction_split as split

    comp = pt_kernels.compaction
    kernels = {"compact_u64": (comp.compact_u64, comp.compact_u64_plain),
               "compact_split": (split.compact_split,
                                 split.compact_split_plain)}
    cases = [(f"n={U64_N} sel={sel}", _u64_inputs(U64_N, sel, dev))
             for sel in (0.5, 0.0, 1.0)]
    cases.append(("n=1024 all kept", _u64_inputs(1024, 1.0, dev)))
    torch.cuda.synchronize()
    for fn, _ in kernels.values():
        fn.launches = 0
    for _, (mask, cols) in cases:
        for fn, _ in kernels.values():
            fn(mask, cols)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on its path")
    errs = {name: 0.0 for name in kernels}
    for label, (mask, cols) in cases:
        for name, (fn, plain) in kernels.items():
            e, k = _check_u64_kernel(fn, plain, comp.compact, mask, cols,
                                     f"{name} {label}")
            errs[name] = max(errs[name], e)
        print(f"compact_u64, compact_split {label} (kept {k}): bit-equal to "
              "their plain versions and to K2, outputs n + 1024 long",
              flush=True)
    mask, cols = cases[0][1]
    k = int(mask.sum())
    n = U64_N
    bound = (n + n * 24 + k * 24) / peak * 1e3
    lib_ms = _time_ms(lambda: [c[mask] for c in cols])
    k2_ms = _time_ms(lambda: comp.compact(mask, cols))
    rows = {}
    for name, (fn, plain) in kernels.items():
        ms = _time_ms(lambda: fn(mask, cols))
        plain_ms = _time_ms(lambda: plain(mask, cols))
        host = _host_us(lambda: fn(mask, cols))
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, host_us=host)
        print(f"{name} n={n} x (i64,i64,f64) sel 0.5 (kept {k}): kernel "
              f"{ms:.4f} ms (host {host:.2f} us per call), plain "
              f"{plain_ms:.4f} ms, mask indexing "
              f"{lib_ms:.4f} ms, K2 compact {k2_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound / ms:.1%} of the HBM bound)",
              flush=True)
    pos = split.positions(mask)
    bases, _ = split.tile_bases(pos)
    a_ms = _time_ms(lambda: split.positions(mask))
    b_ms = _time_ms(lambda: split.place(mask, pos, bases, cols))
    glue_ms = _time_ms(lambda: split.tile_bases(pos))
    a_bound = n * 5 / peak * 1e3
    b_bound = (n * 5 + n * 24 + k * 24) / peak * 1e3
    print(f"compact_split kernel A (positions) {a_ms:.4f} ms (bound "
          f"{a_bound:.4f} ms), torch glue (bases) {glue_ms:.4f} ms, kernel B "
          f"(place) {b_ms:.4f} ms (bound {b_bound:.4f} ms)", flush=True)
    rows["compact_split"].update(kernel_a_ms=a_ms, kernel_b_ms=b_ms)
    return launches, errs, rows


# probe name -> line of its pallas_call in the reference
PROBE_LINES = {"blocked-1d": 41, "blocked-2d": 50, "manual-dma-matmul": 75,
               "cumsum-1d": 90, "smem-output": 100, "dma-in-when": 120}


def phase_probes(dev, peak, device_calls):
    """The probe matrix on the card (counted); every probe must read OK.
    Returns (launches, errors, rows), each keyed by probe name. A probe's
    library call is the one PyTorch call that computes its output (none
    for manual-dma-matmul and dma-in-when, which take two); the two are
    timed in turns. Puts each probe's (call, library call) into
    ``device_calls`` for ``phase_probe_device_times``."""
    from arrow1_tpu_torch.kernels import probes

    torch.cuda.synchronize()
    probes.run_probe.launches = dict.fromkeys(probes.PROBES, 0)
    report = probes.run_probes(dev)
    torch.cuda.synchronize()
    launches = dict(probes.run_probe.launches)
    bad = {k: v for k, v in report.items() if v != "OK"}
    if bad or any(c != 1 for c in launches.values()):
        raise AssertionError(f"probes: {bad or report}, kernel launches "
                             f"{launches}")
    print(f"probes: {report}", flush=True)
    xs = probes.probe_inputs(dev)
    libraries = {"blocked-1d": lambda x: x * 2, "blocked-2d": lambda x: x * 2,
                 "cumsum-1d": lambda x: torch.cumsum(x, 0, dtype=torch.int32),
                 "smem-output": lambda x: x.sum(dtype=torch.int32)}
    errs, rows = {}, {}
    for name, (_, kind) in probes.PROBES.items():
        x = xs[kind]
        got, want = probes.run_probe(name, x), probes.plain(name, x)
        errs[name] = _int_err(got.long(), want.long())
        if errs[name]:
            raise AssertionError(f"probe {name}: differs from its plain "
                                 "version")
        lib = libraries.get(name)
        run = (lambda name=name, x=x: probes.run_probe(name, x))
        r = rows[name] = dict(
            bound_ms=(x.numel() * 4 + got.numel() * 4) / peak * 1e3,
            plain_ms=_time_ms(lambda: probes.plain(name, x),
                              runs=PROBE_RUNS),
            launch_path=("dispatcher" if name in probes.OPERATORS
                         else "ctypes"))
        lib_text = ""
        if lib is None:
            r.update(ms=_time_ms(run, runs=PROBE_RUNS), library_ms=None,
                     host_us=_host_us(run))
        else:
            r["ms"], r["library_ms"] = _time_pair_ms(
                run, lambda lib=lib, x=x: lib(x))
            r["host_us"] = _host_us(run)
            r["library_host_us"] = _host_us(lambda: lib(x))
            lib_text = (f"; library {r['library_ms'] * 1e3:.2f} us "
                        f"(kernel / library {r['ms'] / r['library_ms']:.3f};"
                        f" host {r['library_host_us']:.2f} us)")
        print(f"probe {name}: OK; {r['launch_path']} launch path, kernel "
              f"{r['ms'] * 1e3:.2f} us (median of {PROBE_RUNS}; host "
              f"{r['host_us']:.2f} us over {HOST_CALLS} back to back), "
              f"plain {r['plain_ms'] * 1e3:.2f} us{lib_text}, bound "
              f"{r['bound_ms'] * 1e3:.4f} us", flush=True)
        device_calls[name] = (run, None if lib is None else
                              (lambda lib=lib, x=x: lib(x)))
    return launches, errs, rows


def phase_probe_device_times(device_calls, rows):
    """Device time per call of each probe and of its library call, from
    torch.profiler's kernel records. It runs after every other phase: the
    profiler's CUDA tracing may stay attached to the process and slow the
    launches that follow it. Also checks that the operator probes went
    through the dispatcher: the profiler records their a1t:: operators."""
    from arrow1_tpu_torch.kernels import probes

    for name, (run, lib) in device_calls.items():
        r = rows[name]
        r["device_us"], names, ops = _device_us(run)
        op = f"a1t::{probes.PROBES[name][0]}"
        if name in probes.OPERATORS and op not in ops:
            raise AssertionError(f"probe {name}: the profiler saw no {op} "
                                 f"call, only {sorted(ops)[:8]}")
        text = f"probe {name}: device {_us_text(r['device_us'])} ({names})"
        if lib is not None:
            r["library_device_us"], lib_names, _ = _device_us(lib)
            text += (f"; library device {_us_text(r['library_device_us'])} "
                     f"({lib_names})")
        print(text + f", by torch.profiler over {PROFILE_CALLS} calls",
              flush=True)


def _sf10_oracles(li, orders, customers):
    """Numpy answers of Q1, Q3, Q5 and Q6 over the SF10 tables: per group,
    in each query's output order and column order (aggregates, then the
    key), the integer sums and counts and the float64 sums."""
    flag_codes, flag_pool = li["l_returnflag"]
    price = li["l_extendedprice"]
    qty = li["l_quantity"]
    out = {}
    keep = li["l_shipdate_days"] <= 10000
    fl = flag_codes[keep]
    out["q1"] = dict(
        l_quantity_sum=np.bincount(fl, weights=qty[keep], minlength=3)
        .astype(np.int64),
        l_extendedprice_sum=np.bincount(fl, weights=price[keep],
                                        minlength=3),
        l_quantity_count=np.bincount(fl, minlength=3),
        l_returnflag=flag_pool)
    prio_codes, prio_pool = orders["o_orderpriority"]
    okey = li["l_orderkey"]   # o_orderkey is arange: a key is its row
    prio = prio_codes[okey]
    sums = np.bincount(prio, weights=price, minlength=3)
    order = np.argsort(-sums, kind="stable")[:10]
    out["q3"] = dict(l_extendedprice_sum=sums[order],
                     l_orderkey_count=np.bincount(prio, minlength=3)[order],
                     o_orderpriority=prio_pool[order])
    seg_codes, seg_pool = customers["c_segment"]
    seg = seg_codes[orders["o_custkey"][okey]]
    sums = np.bincount(seg, weights=price, minlength=3)
    order = np.argsort(-sums, kind="stable")[:10]
    out["q5"] = dict(l_extendedprice_sum=sums[order],
                     c_segment=seg_pool[order])
    disc = li["l_discount"]
    keep = (disc >= 0.02) & (disc <= 0.09) & (qty < 24)
    out["q6"] = dict(l_extendedprice_sum=np.bincount(
        flag_codes[keep], weights=price[keep], minlength=3),
        l_returnflag=flag_pool)
    return out


def _check_sf10(out, want, label, key=None):
    """A query's batch against ``want`` (name -> numpy array): exact for
    strings and integers, SF10_RTOL for float64 sums. With ``key``, rows
    are matched by that column (group order is the path's)."""
    got = {n: out[n].to_numpy() for n in out.names}
    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)}, oracle "
                             f"{list(want)}")
    if key is not None:
        pos = {v: i for i, v in enumerate(got[key].tolist())}
        order = [pos.get(v, -1) for v in want[key].tolist()]
        if sorted(order) != list(range(len(got[key]))):
            raise AssertionError(f"{label}: groups {got[key]} vs oracle "
                                 f"{want[key]}")
        got = {n: v[order] for n, v in got.items()}
    for name, ref in want.items():
        g = got[name]
        ok = len(g) == len(ref) and (
            np.allclose(g.astype(np.float64), ref, rtol=SF10_RTOL, atol=0)
            if ref.dtype.kind == "f" else g.tolist() == ref.tolist())
        if not ok:
            raise AssertionError(f"{label}: column {name} {g} differs from "
                                 f"{ref}")


class _CallCounter:
    """Stands in for ``ops.join.join`` and counts its calls (each builds
    a hash table)."""

    def __init__(self, real):
        self.real = real
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs)


def phase_sf10(pt, dev, peak, counted):
    """The query layer at TPC-H SF10 cardinalities. Returns the launch
    counts of the counted runs."""
    import arrow1_tpu_torch.ops.join as ops_join
    import arrow1_tpu_torch.profile_main_path as pm
    from arrow1_tpu_torch import acero, models
    from arrow1_tpu_torch.exec import plan

    t0 = time.perf_counter()
    li, orders, customers = pm.tpch_tables(pm.SF10_LINEITEM // SF10_SCALE,
                                           pm.SF10_ORDERS // SF10_SCALE,
                                           pm.SF10_CUSTOMERS // SF10_SCALE)
    want = _sf10_oracles(li, orders, customers)
    lt = pm.as_table(li, dev)
    ob, cb = pm.q3_batch(orders, dev), pm.q3_batch(customers, dev)
    n_li = li["l_orderkey"].shape[0]
    del li, orders, customers
    torch.cuda.synchronize()
    print(f"SF10 data: {n_li} line items in {len(lt.batches)} batches, "
          f"{ob.num_rows} orders, {cb.num_rows} customers; made and "
          f"copied in {time.perf_counter() - t0:.1f} s", flush=True)

    def acero_q1():
        return acero.Declaration.from_sequence([
            acero.Declaration("table_source",
                              acero.TableSourceNodeOptions(lt)),
            acero.Declaration("filter", acero.FilterNodeOptions(
                pt.field("l_shipdate_days") <= 10000)),
            acero.Declaration("aggregate", acero.AggregateNodeOptions(
                [("l_quantity", "sum"), ("l_extendedprice", "sum"),
                 ("l_quantity", "count")], keys=["l_returnflag"])),
            acero.Declaration("order_by", acero.OrderByNodeOptions(
                [("l_returnflag", "ascending")]))]).to_table() \
            .combine_chunks()

    def plan_q3():
        p = plan.ExecPlan()
        join = plan.join_node(p, plan.source_node(p, lt.batches),
                              plan.source_node(p, [ob]), ["l_orderkey"],
                              ["o_orderkey"])
        agg = plan.aggregate_node(p, join, ["o_orderpriority"],
                                  [("l_extendedprice", "sum"),
                                   ("l_orderkey", "count")])
        sink = plan.sink_node(p, plan.order_by_node(
            p, agg, [("l_extendedprice_sum", "descending")]))
        p.run()
        return sink.result.combine_chunks()

    # (label, run, oracle, key to match groups by, bytes the query reads)
    n_o, n_c = ob.num_rows, cb.num_rows
    queries = [
        ("Q1 query()", lambda: models.q1_pricing_summary(lt), "q1", None,
         n_li * 28),
        ("Q1 acero", acero_q1, "q1", None, n_li * 28),
        ("Q3 query()", lambda: models.q3_shipping_priority(lt, ob), "q3",
         None, n_li * 16 + n_o * 12),
        ("Q3 exec.plan", plan_q3, "q3", None, n_li * 16 + n_o * 12),
        ("Q5 query()", lambda: models.q5_local_supplier_volume(lt, ob, cb),
         "q5", None, n_li * 16 + n_o * 16 + n_c * 12),
        ("Q6 query()", lambda: models.q6_forecast(lt), "q6", "l_returnflag",
         n_li * 28),
    ]
    launches = {kern.__name__: 0 for kern in counted}
    results = {}
    for label, run, oracle, key, nbytes in queries:
        run()   # warm-up (uncounted)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in counted:
            kern.launches = 0
        counter = _CallCounter(ops_join.join)
        ops_join.join = counter
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            ops_join.join = counter.real
        mem = torch.cuda.max_memory_allocated()
        run_launches = {kern.__name__: kern.launches for kern in counted}
        for name, count in run_launches.items():
            launches[name] += count
        if run_launches["compact"] <= 0 and oracle in ("q1", "q6"):
            raise AssertionError(f"{label}: the filter launched no K2")
        _check_sf10(out, want[oracle], label, key)
        if oracle in results:   # acero and the plan against query()
            _check_sf10(out, {n: results[oracle][n].to_numpy()
                              for n in results[oracle].names},
                        f"{label} against query()", key)
        else:
            results[oracle] = out
        del out
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"TPC-H SF10 {label}: matches the numpy oracle; wall "
              f"{statistics.median(walls) * 1e3:.3f} ms (median of 3), peak "
              f"device memory {mem / 2**30:.2f} GiB, least-bytes bound "
              f"{nbytes / peak * 1e3:.4f} ms ({nbytes / 1e9:.3f} GB); one "
              f"run: K2 {run_launches['compact']}, K3 "
              f"{run_launches['segment_sums']}, hash-join calls "
              f"{counter.calls}", flush=True)
    return launches


def _check_config3(out, inp):
    """On the card: ``out`` is a permutation of ``inp``'s rows, sorted on
    (rank of s ascending, k descending, nulls last), and stable. Rows are
    identified by (price bits, pay), which must be distinct."""
    def by_id(b):   # stable order of the rows by (price bits, pay)
        pay, pb = b["pay"].data, b["price"].data.view(torch.int64)
        o = torch.argsort(pay, stable=True)
        return o[torch.argsort(pb[o], stable=True)]

    oi, oo = by_id(inp), by_id(out)
    pb_i = inp["price"].data.view(torch.int64)[oi]
    pay_i = inp["pay"].data[oi]
    if bool(((pb_i[1:] == pb_i[:-1]) & (pay_i[1:] == pay_i[:-1])).any()):
        raise AssertionError("config 3: (price, pay) does not identify the "
                             "input rows")
    idx = torch.empty_like(oi)
    idx[oo] = oi   # the input row of each output row
    for name in ("s", "k", "pay", "price"):
        a, b = out[name], inp[name]
        bits = (lambda t: t.view(torch.int64)) if name == "price" else \
            (lambda t: t)
        if not torch.equal(bits(a.data), bits(b.data)[idx]) or \
                not torch.equal(a.mask(), b.mask()[idx]):
            raise AssertionError(f"config 3: column {name} is not a "
                                 "permutation of the input's")
    rank = torch.from_numpy(out["s"].dictionary.rank.astype(np.int64)).to(
        idx.device)[out["s"].data.long()]
    null = ~out["k"].mask()
    kd = torch.where(null, 0, -out["k"].data)   # descending; nulls tie
    r0, r1, c0, c1, k0, k1 = (rank[:-1], rank[1:], null[:-1], null[1:],
                              kd[:-1], kd[1:])
    eq = (r0 == r1) & (c0 == c1) & (k0 == k1)
    lt = (r0 < r1) | ((r0 == r1) & ((c0 < c1) | ((c0 == c1) & (k0 < k1))))
    if not bool((lt | eq).all()):
        raise AssertionError("config 3: the output is not sorted")
    if not bool((~eq | (idx[:-1] < idx[1:])).all()):
        raise AssertionError("config 3: the sort is not stable")


def phase_config3(dev):
    """BASELINE config 3 through models.baseline_sort."""
    import arrow1_tpu_torch.profile_main_path as pm
    from arrow1_tpu_torch import models

    t0 = time.perf_counter()
    batch = pm.sort_batch(pm.sort_data(SORT_ROWS), dev)
    torch.cuda.synchronize()
    print(f"config 3 data: {batch.num_rows} rows made and copied in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    models.baseline_sort(batch, pm.CONFIG3_KEYS)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = models.baseline_sort(batch, pm.CONFIG3_KEYS)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated()
    _check_config3(out, batch)
    del out
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models.baseline_sort(batch, pm.CONFIG3_KEYS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"config 3 sort of {batch.num_rows} rows on (s, k desc): a "
          f"sorted, stable permutation of the input; wall "
          f"{statistics.median(walls) * 1e3:.3f} ms (median of 3), peak "
          f"device memory {mem / 2**30:.2f} GiB", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import arrow1_tpu_torch as pt
    import arrow1_tpu_torch.ops.padded as padded
    import arrow1_tpu_torch.ops.selection as selection
    from arrow1_tpu_torch import kernels as pt_kernels
    from arrow1_tpu_torch.kernels import (build, compaction, fused_ops,
                                         hashtable, segsum, segsum2)

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    card = _card_line()
    peak = _peak(name)
    t0 = time.perf_counter()
    build.build(build.TARGETS)
    build_s = time.perf_counter() - t0
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; HBM peak {peak:.3g} B/s (data sheet); "
          f"kernels built in {build_s:.1f} s", flush=True)
    for src in build.TARGETS:
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

    # every kernel's count is set to 0 before each path and read after it
    all_kernels = (compaction.compact, fused_ops.filter_project_flagship,
                   segsum2.segment_sums, segsum.segment_sum_count,
                   hashtable.broadcast_probe)
    kernels = (compaction.compact, fused_ops.filter_project_flagship)
    for kern in all_kernels:
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
    for sel in (0.25, 0.5):   # thresh 0.0 on f: bench.py's recipe
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
                          bound_ms=bound, _size=n * len(cols),
                          _args=(mask, cols, lim))
    if k2_row is None:
        raise AssertionError("the pipeline made no K2 call")
    k2_row.pop("_size")
    k2_args = k2_row.pop("_args")
    k2_row["host_us"] = _host_us(lambda: compaction.compact(*k2_args))
    print(f"K2 on the main path, its largest call: host "
          f"{k2_row['host_us']:.2f} us per call ({HOST_CALLS} back to back)",
          flush=True)
    del k2_args

    # ---- phases 5 and 6: group accumulators and the eager group_by ----
    k3_err, k3_row = phase_segment_sums(segsum2, dev, peak)
    v1_err, v1_row = phase_segment_sum_count(segsum, dev, peak)
    gb_launches = phase_group_by(pt, dev, all_kernels)
    print(f"group_by main path launches: {gb_launches}", flush=True)
    if gb_launches["segment_sums"] != 2:
        raise AssertionError(f"K3 launched {gb_launches['segment_sums']} "
                             "times in the group_by run, not 2")
    for kname, count in gb_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    phase_float_sums(pt, dev)

    # ---- phases 7 to 9: K4 and the joins ------------------------------
    del configs, fkey, fv, ff, recorder
    torch.cuda.empty_cache()
    k4_launches, k4_err, k4_row = phase_broadcast_probe(
        pt, hashtable, padded, dev, peak, all_kernels)
    join_launches = phase_join(pt, dev, peak, all_kernels)
    torch.cuda.empty_cache()
    q3_launches = phase_q3(pt, dev, all_kernels)
    for label, counts in (("K4", k4_launches), ("config-4 join",
                                                join_launches),
                          ("Q3", q3_launches)):
        print(f"{label} main path launches: {counts}", flush=True)
        for kname, count in counts.items():
            launches[kname] = launches.get(kname, 0) + count

    # ---- phases 10 to 13: the last kernels and the query layer -------
    torch.cuda.empty_cache()
    u64_launches, u64_errs, u64_rows = phase_u64_compaction(pt_kernels, dev,
                                                            peak)
    probe_calls = {}
    probe_launches, probe_errs, probe_rows = phase_probes(dev, peak,
                                                          probe_calls)
    print(f"compaction variants launches: {u64_launches}; probe launches: "
          f"{probe_launches}", flush=True)
    launches.update(u64_launches)
    torch.cuda.empty_cache()
    sf10_launches = phase_sf10(pt, dev, peak, all_kernels)
    print(f"SF10 query layer launches: {sf10_launches}", flush=True)
    for kname, count in sf10_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    phase_config3(dev)
    phase_probe_device_times(probe_calls, probe_rows)

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
        dict(name="segment_sums", route="cuda",
             source="arrow1_tpu_torch/csrc/segment_sums.cu",
             replaces="arrow1_tpu/kernels/segsum2.py:195",
             launches=launches["segment_sums"], max_abs_err=k3_err,
             bound_by="bytes", **k3_row),
        dict(name="segment_sum_count", route="cuda",
             source="arrow1_tpu_torch/csrc/segment_sums.cu",
             replaces="arrow1_tpu/kernels/segsum.py:69",
             launches=launches["segment_sum_count"], max_abs_err=v1_err,
             bound_by="bytes", **v1_row),
        dict(name="broadcast_probe", route="cuda",
             source="arrow1_tpu_torch/csrc/broadcast_probe.cu",
             replaces="arrow1_tpu/kernels/hashtable.py:500",
             launches=launches["broadcast_probe"], max_abs_err=k4_err,
             bound_by="bytes", **k4_row),
        dict(name="compact_u64", route="cuda",
             source="arrow1_tpu_torch/csrc/compact_u64.cu",
             replaces="arrow1_tpu/kernels/compaction.py:148",
             launches=launches["compact_u64"],
             max_abs_err=u64_errs["compact_u64"], bound_by="bytes",
             **u64_rows["compact_u64"]),
        dict(name="compact_split", route="cuda",
             source="arrow1_tpu_torch/csrc/compaction_split.cu",
             replaces="arrow1_tpu/kernels/compaction_split.py:148",
             launches=launches["compact_split"],
             max_abs_err=u64_errs["compact_split"], bound_by="bytes",
             **u64_rows["compact_split"]),
    ] + [
        dict(name=f"run_probes/{pname}", route="cuda",
             source=("arrow1_tpu_torch/csrc/probe_ops.cu"
                     if probe_rows[pname]["launch_path"] == "dispatcher"
                     else "arrow1_tpu_torch/csrc/probes.cu"),
             replaces=f"arrow1_tpu/kernels/tpu_probes.py:{line}",
             launches=probe_launches[pname], max_abs_err=probe_errs[pname],
             bound_by="bytes", **probe_rows[pname])
        for pname, line in PROBE_LINES.items()]}
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s (build included)",
          flush=True)
    print(card)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
