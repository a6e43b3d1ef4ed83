#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (arrow1_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout:

    python3 chip_smoke.py

It builds every CUDA kernel from arrow1_tpu_torch/csrc (one nvcc per
library, all at once: one per ctypes source, and the operator library of
probe_ops.cu and probe_ops.cpp, which holds the six probes), then:

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
   version is held to the same bound), with ids spread over the groups
   and with every row in one group, each printed with its regime
   (kernels/segsum.py:plan). Kernel, plain version and library call
   (torch.bincount and one index_add_ per output) are timed;
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
   [0, 2^40), T in {256, 1024, 2048}), on a second probe set (half the
   probes drawn from a build with duplicate runs, keys above 2^63) and on
   a clustered build (T = 2048: 2047 keys in a window 2^12 wide, and
   2^64 - 1), with its launch count set to 0 before and read after; holds
   it bit for bit against its plain version, the port's sort-merge probe
   (lo, counts) and the hash-table probe's counts, and times kernel, plain
   version and library call (two torch.searchsorted) on the r2 and
   clustered sets;
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
   all six go through their PyTorch operators (torch.ops.a1t), one
   launch a call. Each probe's kernel, the empty kernel behind the same
   operator path (torch.ops.a1t.probe_empty: a probe's launch bound)
   and, where one PyTorch call computes the same output, that library
   call are timed in turns (CUDA events, median of PROBE_RUNS), the
   plain version alone, and each with its host time per call
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
14. runs the numeric compute tail (arrow1_tpu_torch/compute_tail.py:
   99 functions of validity, selection, numeric cast, the sort tail,
   element-wise min/max, power/abs/sign, bitwise, math, cumulative,
   conditional, set lookup, run ends and random) once each on the card at
   TAIL_ROWS of BASELINE config 1's columns (10% nulls, NaN in f, a uint64
   view of key, a dictionary column), timed, each held against the same
   call on CPU tensors over the first TAIL_WINDOW rows (exact, or within
   its stated ulp bound; random by its properties), and one query through
   query() (is_valid, isin, is_null, cast and fill_null) against numpy,
   whose K2 launches are counted and must be above 0;
15. runs the strings (arrow1_tpu_torch/compute_strings.py: 73 names)
   once each on the card over STRING_ROWS-row dictionary columns from a
   seed, TPC-H's l_shipmode (7 values) and SF10's c_name (1.5M values),
   the byte-matrix names on both and the host-routed ones on an SF1
   c_name (150K values), each call's wall time printed and its output
   held against the same call on CPU tensors over the first
   STRING_WINDOW rows, exactly; then one query() with a string filter
   (starts_with and ==) and projection (utf8_length, ascii_lower) over
   ten 2^20-row batches against numpy, whose K2 launches are counted and
   must be above 0;
16. runs the temporal slice (arrow1_tpu_torch/compute_temporal.py: 43
   names) once each on the card over TEMPORAL_ROWS-row columns from a
   seed (date32 ship dates, timestamps over 1969-2030 plain and in
   America/New_York, naive wall times, strftime/strptime over a pool of
   TEMPORAL_DISTINCT instants), each timed and held against the same
   call on CPU tensors over the first TEMPORAL_WINDOW rows, exactly; then
   TPC-H Q1 at SF10 over phase 12's line items with the spec's ship-date
   predicate on a date32 column (<= 1998-09-02), projecting
   year(l_shipdate), grouped by l_returnflag (equal to the numpy oracle
   and to the int-days template row for row) and by the year (equal to
   numpy), whose K2 launches are counted and must be above 0; and
   assume_timezone -> hour/is_dst/local_timestamp at TEMPORAL_ROWS with
   the zone's offset table on the card;
17. runs the decimal slice (arrow1_tpu_torch/compute_decimal.py: one
   call of each decimal dispatch point) once each on the card over
   DECIMAL_ROWS-row columns from a seed (decimal128(15, 2), (38, 10)
   across the 2^64 limb boundary, decimal256(60, 6)), each timed and held
   against the same call on CPU tensors over the first DECIMAL_WINDOW
   rows, exactly; then TPC-H Q1 at SF10 over phase 12's line items on
   DECIMAL(15,2) quantity, price, discount and tax (sum_charge through
   decimal256), grouped by l_returnflag and by year(l_shipdate), and Q6,
   each equal to an exact oracle in Python ints, with its K2 (and, by
   year, K3) launches counted and above 0;
18. takes each probe's, its library call's and the empty kernel's device
   time per call from torch.profiler's kernel records (PROFILE_CALLS
   calls), last, because the profiler's CUDA tracing may stay attached to
   the process and slow the launches after it; every probe must show its
   a1t:: operator in the profile;
19. (run before 18, over phase 12's line items) nests the SF10 line items
   under their 15M orders: hash_list by l_orderkey, the list functions,
   a K2 filter of the orders batch that holds the list columns,
   hash_distinct, a map per order and map_lookup, make_struct and
   struct_field, hash_tdigest by flag, the split family over 10M string
   rows and binary_join back, each timed and held against the same call
   on CPU tensors over the first NESTED_WINDOW orders or rows, with
   round trips at full size; then Q1's quantities by (year, flag) pivoted
   wide (hash_pivot_wider, pivot_wider) against numpy; its K2 launches
   are counted and must be above 0;
20. (run after 19) opens a one-rank NCCL process group on the card
   (parallel.multihost.initialize over an in-process store) and runs the
   distributed operators over config 2's 10M rows (seed 0): dist_filter,
   dist_group_by at G = 1000 and 2^20, dist_join inner and left outer
   (a 500-key dimension), dist_sort; then q1_distributed and
   q3_distributed over phase 12's SF10 tables. Each result must equal the
   single-card engine's on the same input (integers, keys and nulls
   exactly, float64 within SF10_RTOL, the sort the same permutation; Q1
   and Q3 also the numpy oracle); prints each call's wall (median of 3),
   peak device memory, bytes through all_to_all_single and K2 launches,
   which must be above 0. Phase 12 also checks that Q3 builds its hash
   table once and Q5 twice (one build a join);
21. (run after 20) the host plane over phase 12's SF10 line items: writes
   them to an Arrow IPC file with io.ipc.write_ipc in a fresh temporary
   directory (its free bytes printed first; a short disk fails the
   phase), reads the file straight onto the card with read_ipc, and runs
   TPC-H Q1 on it (bit-equal to Q1 over the in-memory table and equal to
   the numpy oracle) and Q1 by year(l_shipdate) (the oracle), with their
   K2 and K3 launches counted; reads the file again through
   io.prefetch.prefetch_batches (CPU decode, then the card) and holds the
   batches against the first read; writes the first 8 batches with LZ4
   and reads them back; writes the orders batch as Feather V2
   (feather.write_table/read_table) and V1 (io.feather1) and reads both
   back; profiles filter, add and sum over the read columns with
   profiler.KernelProfiler (its bytes against the tensors' own); prints
   build_info, runtime_info and total_allocated_bytes, each wall with
   GB/s and the peak device memory; the native library (native/src,
   built with g++) must have been used, and no pyarrow, flatbuffers or
   zstandard module imported;
22. (run after 21) the file formats over phase 12's SF10 line items with
   their date32 ship date (phase 16's table), one format at a time in a
   fresh temporary directory, each file deleted before the next: CSV
   (io.csv.write_csv; read_csv onto the card, equal to the table column
   for column, floats bit for bit; open_csv_stream in 2^20-row batches
   into Q1 and Q1 by year, bit-equal to the same queries over the
   in-memory table); SF10's 15M orders as newline-delimited JSON made
   with numpy, read with read_json onto the card (equal to the orders
   batch) into Q3 through query() (the numpy oracle); Parquet
   (write_parquet with 2^20-row row groups and snappy; read_parquet and
   iter_parquet_batches onto the card, equal batch for batch; Q1 and Q1
   by year bit-equal to the in-memory ones; a columns= projection and a
   filters= read equal to the same projection and filter of the
   in-memory table); ORC (write_orc, one stripe a batch; read_orc onto
   the card, equal batch for batch; Q1 and Q1 by year bit-equal to the
   in-memory ones); the orders' int64 columns through the
   C++ IPC writer (io.ipc_cpp) read back with read_ipc onto the card.
   Each leg prints its write wall, file size, read wall and GB/s, the
   wall of the query it feeds with the K2 and K3 launches of one counted
   run (above 0 where Q1 runs), the peak device memory and the card's
   name and power limit; no pyarrow, zstandard or cryptography module
   may be imported;
23. writes the same line items, with l_shipyear = year(l_shipdate), as a
   Hive-partitioned Parquet dataset (dataset.write_dataset, one file a
   ship year) in a fresh temporary directory and reads it back:
   dataset(root, partitioning="hive") must find one fragment a year and
   count every row, and to_table onto the card must equal the source
   year by year in source order, bit for bit (each batch valid under
   validate_batch(full=True)); Q1 and Q1 by year through query(dataset)
   equal the numpy oracles (K2 and K3 launched); Q6 with l_shipyear ==
   1994 must keep one fragment and decode one file, and equal a numpy
   oracle; a ScannerBuilder filter and projection, head(1000) and
   ParquetDataset(root) equal the same operations on the in-memory
   table. One year's files go through mock S3 (SigV4 checked on every
   request) and WebHDFS servers on 127.0.0.1 with the native clients and
   are read back as datasets over s3:// and webhdfs:// URIs, equal to the
   local read. Then the bridges: SF10's 15M orders through the C stream
   interface and back onto the card; builders of 10M int64, float64 and
   string values against numpy; a tensor.Tensor of three float64 columns
   of 10M rows through to_coo, to_csr, to_dense and matvec against the
   same calls on the CPU; gandiva's Filter and Projector of Q6 over one
   year's batches against query(); the orders' int64 columns through the
   plasma store, read back here and in a child process. Each leg prints
   its walls, GB/s where bytes move, the peak device memory and the
   card's name and power limit; no pyarrow, jax, grpc, zstandard or
   cryptography module may be imported.

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
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
TAIL_ROWS = 10_000_000               # the compute tail at config 1's size
TAIL_WINDOW = 1_000_000              # rows held against the CPU
TAIL_RUNS = 5                        # event timings of each tail call
STRING_ROWS = 10_000_000             # each string column's rows
STRING_WINDOW = 1_000_000            # rows held against the CPU
SF10_CUSTOMERS = 1_500_000           # c_name's distinct values at SF10
SF1_CUSTOMERS = 150_000              # the host-routed names' pool (SF1)
STRING_BATCHES = 10                  # the string query's 2^20-row batches
TEMPORAL_ROWS = 10_000_000           # each temporal column's rows
TEMPORAL_WINDOW = 1_000_000          # rows held against the CPU
TEMPORAL_DISTINCT = 150_000          # strftime/strptime's pool (SF1-sized)
Q1_CUTOFF = 10471   # 1998-09-02 = date '1998-12-01' - 90 days (TPC-H Q1)
HOST_PLANE_LZ4_BATCHES = 8           # phase 21's compressed leg
HOST_PLANE_PROFILE_REPEATS = 5       # phase 21's profiled calls of each


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _peak() -> float:
    """The card's data-sheet HBM bandwidth, from the port's one table
    (profiler.HBM_PEAK); raises for a card it does not know."""
    from arrow1_tpu_torch import profiler

    return profiler.hbm_peak_bytes_per_sec(DEVICE)


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


def _time_turns_ms(fns, runs=PROBE_RUNS, warmup=3):
    """Medians of per-call CUDA-event times of functions called in turns
    (a b c, b c a, c a b, ...), so that all meet the same host."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    ev = [[(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
          for _ in fns]
    for i in range(runs):
        for j in range(len(fns)):
            k = (i + j) % len(fns)
            start, end = ev[k][i]
            start.record()
            fns[k]()
            end.record()
    torch.cuda.synchronize()
    return tuple(statistics.median(s.elapsed_time(e) for s, e in evs)
                 for evs in ev)


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


def phase_segment_sum_count(segsum, segsum2, dev, peak):
    """segsum v1 against its plain version at 10M rows, G = 4096, with ids
    spread over the groups and with every row in one group. Returns (max
    |kernel - plain| of the sums, row of the spread shape)."""
    G = 4096
    rng = np.random.default_rng(1)
    spread = rng.integers(0, G, N_BIG)
    dead = rng.random(N_BIG) < 0.05
    val = torch.from_numpy(rng.standard_normal(N_BIG).astype(
        np.float32)).to(dev)
    live = torch.from_numpy(rng.random(N_BIG) >= 0.1).to(dev)
    path = segsum.plan(G, segsum2.smem_bytes()).mode
    err, row = 0.0, None
    for label, ids in (("spread", spread), ("one hot group", 0 * spread)):
        gid = torch.from_numpy(np.where(dead, G, ids).astype(np.int32)).to(
            dev)
        s, c = segsum.segment_sum_count(gid, val, live, G)
        sp, cp = segsum.segment_sum_count_plain(gid, val, live, G)
        keep = live & (gid < G)
        idx = torch.where(keep, gid, G).long()
        ref = torch.zeros(G + 1, dtype=torch.float64,
                          device=dev).index_add_(
            0, idx, torch.where(keep, val, 0.0).double())[:G]
        abs_sum = torch.zeros(G + 1, dtype=torch.float64,
                              device=dev).index_add_(
            0, idx, torch.where(keep, val.abs(), 0.0).double())[:G]
        if not torch.equal(c, cp):
            raise AssertionError(f"v1 counts differ from plain ({label})")
        for name, got in (("kernel", s), ("plain", sp)):
            if not bool(((got.double() - ref).abs()
                         <= 1e-5 * abs_sum).all()):
                raise AssertionError(f"v1 {name} sums outside 1e-5 * sum|v|"
                                     f" of the float64 reference ({label})")
        e = _max_abs_err(s, sp)
        err = max(err, e)
        ms = _time_ms(lambda: segsum.segment_sum_count(gid, val, live, G))
        plain_ms = _time_ms(lambda: segsum.segment_sum_count_plain(
            gid, val, live, G))
        masked = torch.where(keep, val, 0.0)

        def library():
            return (torch.zeros(G + 1, dtype=torch.float32,
                                device=dev).index_add_(0, idx, masked),
                    torch.bincount(idx, minlength=G + 1))

        lib_ms = _time_ms(library)
        nbytes = N_BIG * (4 + 4 + 1) + G * 4 * 2
        bound = nbytes / peak * 1e3
        print(f"v1 segment_sum_count 10M rows, G={G}, {label} ({path}): "
              f"counts exact, sums within 1e-5 * sum|v| (max |kernel - "
              f"plain| {e:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, index_add_+bincount {lib_ms:.4f} ms, bound {bound:.4f} "
              f"ms ({bound / ms:.1%} of the HBM bound)", flush=True)
        if row is None:
            host = _host_us(lambda: segsum.segment_sum_count(gid, val, live,
                                                             G))
            print(f"v1 segment_sum_count G={G}: host {host:.2f} us per "
                  f"call ({HOST_CALLS} back to back)", flush=True)
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, host_us=host)
    return err, row


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
    half drawn from the build; and a clustered set (seed 8): T - 1 keys
    drawn with repeats from a window 2^12 wide, and 2^64 - 1, so that all
    but one lie in one bucket of K4's directory, probes half drawn from
    the build and half from the window. Keys are int64 bit patterns."""
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
    rng = np.random.default_rng(8)
    T = K4_TS[-1]
    base = np.uint64(rng.integers(0, 1 << 63))
    window = base + rng.integers(0, 1 << 12, T - 1).astype(np.uint64)
    build = np.sort(np.append(window, np.iinfo(np.uint64).max))
    probe = np.concatenate([
        rng.choice(build, K4_N // 2),
        base + rng.integers(0, 1 << 12, K4_N - K4_N // 2).astype(np.uint64)])
    rng.shuffle(probe)
    sets.append((f"clustered T={T}", T, build, probe))
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
        if not label.startswith("duplicates"):
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
            if label == f"r2 T={K4_TS[-1]}":
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
    Returns (launches, errors, rows), each keyed by probe name. Every
    probe is an operator of PyTorch's dispatcher; its kernel, the empty
    kernel behind the same operator path (``probes.run_empty``: the least
    a probe call can take, its launch bound) and, where one PyTorch call
    computes its output, that library call (none for manual-dma-matmul
    and dma-in-when, which take two) are timed in turns. Puts each
    probe's (call, library call) into ``device_calls`` for
    ``phase_probe_device_times``."""
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
        before = probes.run_probe.launches[name]
        got, want = probes.run_probe(name, x), probes.plain(name, x)
        if probes.run_probe.launches[name] != before + 1:
            raise AssertionError(f"probe {name}: one call did not count one "
                                 "launch")
        errs[name] = _int_err(got.long(), want.long())
        if errs[name]:
            raise AssertionError(f"probe {name}: differs from its plain "
                                 "version")
        lib = libraries.get(name)
        run = (lambda name=name, x=x: probes.run_probe(name, x))
        empty = (lambda x=x: probes.run_empty(x))
        r = rows[name] = dict(
            bound_ms=(x.numel() * 4 + got.numel() * 4) / peak * 1e3,
            plain_ms=_time_ms(lambda: probes.plain(name, x),
                              runs=PROBE_RUNS))
        lib_text = ""
        if lib is None:
            r["ms"], r["empty_kernel_ms"] = _time_turns_ms((run, empty))
            r["library_ms"] = None
        else:
            r["ms"], r["empty_kernel_ms"], r["library_ms"] = _time_turns_ms(
                (run, empty, lambda lib=lib, x=x: lib(x)))
            r["library_host_us"] = _host_us(lambda: lib(x))
            lib_text = (f"; library {r['library_ms'] * 1e3:.2f} us "
                        f"(kernel / library {r['ms'] / r['library_ms']:.3f};"
                        f" host {r['library_host_us']:.2f} us)")
        r["host_us"] = _host_us(run)
        r["empty_kernel_host_us"] = _host_us(empty)
        r["share_of_empty_kernel"] = r["empty_kernel_ms"] / r["ms"]
        print(f"probe {name}: OK; dispatcher launch path, kernel "
              f"{r['ms'] * 1e3:.2f} us (median of {PROBE_RUNS}; host "
              f"{r['host_us']:.2f} us over {HOST_CALLS} back to back), "
              f"empty kernel {r['empty_kernel_ms'] * 1e3:.2f} us in the same "
              f"turns (host {r['empty_kernel_host_us']:.2f} us; share "
              f"{r['share_of_empty_kernel']:.3f}), plain "
              f"{r['plain_ms'] * 1e3:.2f} us{lib_text}, byte bound "
              f"{r['bound_ms'] * 1e3:.4f} us", flush=True)
        device_calls[name] = (run, None if lib is None else
                              (lambda lib=lib, x=x: lib(x)))
    device_calls["empty kernel"] = (lambda x=xs["x2"]: probes.run_empty(x),
                                    None)
    return launches, errs, rows


def phase_compute_tail(pt, dev, counted):
    """Every function of the numeric compute tail (99 names,
    ``arrow1_tpu_torch.compute_tail.CALLS``) once on the card at
    TAIL_ROWS of BASELINE config 1's columns (seed 0; 10% nulls, NaN in f,
    a uint64 view of key, a dictionary column), timed (median of
    TAIL_RUNS CUDA-event runs), and held against the same call on CPU
    tensors over the first TAIL_WINDOW rows: a map or prefix call's
    full-size output over its first rows, any other call run on the
    window on both; exact, or within the call's stated ulp bound. random
    is held to its properties. Then one query through query(): a filter
    on f.is_valid() & key.isin(...) & ~v.is_null(), projecting
    v.cast(float64) and fill_null(f, 0.0), over a Table of 2^20-row
    batches, against numpy; its K2 launches are counted (set to 0 before,
    read after) and must be above 0. Returns the launches."""
    from arrow1_tpu_torch import compute_tail as ct
    from arrow1_tpu_torch.kernels import compaction

    t_phase = time.perf_counter()
    cols = ct.tail_columns(TAIL_ROWS, dev, window=TAIL_WINDOW)
    window = ct.window_of(cols, TAIL_WINDOW)
    host = ct.on_device(window, "cpu")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    failures, times = [], {}
    for name, (call, kind, ulps) in ct.CALLS.items():
        out = call(cols)
        torch.cuda.synchronize()
        first = out.columns[0] if isinstance(out, pt.RecordBatch) else out
        if first.data.device.type != "cuda":
            failures.append(f"{name}: ran on {first.data.device}")
            continue
        times[name] = _time_ms(lambda call=call: call(cols),
                               runs=TAIL_RUNS, warmup=1)
        if kind == "random":
            x = out.data
            again = call(cols).data
            if not (torch.equal(x, again) and out.length == TAIL_ROWS and
                    float(x.min()) >= 0.0 and float(x.max()) < 1.0 and
                    abs(float(x.mean()) - 0.5) < 1e-3):
                failures.append(f"{name}: not uniform [0, 1) of its seed")
            continue
        want = call(host)
        if kind in ("map", "prefix"):
            problem = ct.same_result(out, want, ulps, rows=want.length)
        else:
            problem = ct.same_result(call(window), want, ulps)
        if problem:
            failures.append(f"{name}: {problem}")
    if failures:
        raise AssertionError("compute tail: " + "; ".join(failures))
    calls_s = time.perf_counter() - t_phase - build_s
    slowest = sorted(times.items(), key=lambda kv: -kv[1])
    print(f"compute tail: {len(times)} functions ran on the card at "
          f"{TAIL_ROWS} rows and matched the CPU over the first "
          f"{TAIL_WINDOW} rows (columns built in {build_s:.1f} s, calls and "
          f"checks {calls_s:.1f} s); card ms (median of {TAIL_RUNS}): "
          + ", ".join(f"{n} {t:.4f}" for n, t in sorted(times.items())),
          flush=True)
    print(f"compute tail, slowest on the card: "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in slowest[:8]), flush=True)

    # the query layer: a filter and projection of this slice's methods
    key, v, f = (cols[c] for c in ("key", "v", "f"))
    members = list(range(0, 1 << 20, 97))
    batches = [pt.RecordBatch((key.slice(lo, 1 << 20), v.slice(lo, 1 << 20),
                               f.slice(lo, 1 << 20)), ("key", "v", "f"))
               for lo in range(0, TAIL_ROWS, 1 << 20)]
    table = pt.Table.from_batches(batches)

    def run_query():
        return (pt.query(table)
                .filter(pt.field("f").is_valid()
                        & pt.field("key").isin(members)
                        & ~pt.field("v").is_null())
                .project([pt.field("v").cast(pt.float64),
                          pt.call("fill_null", [pt.field("f"), 0.0])],
                         ["vf", "f0"])
                .to_table())

    for kern in counted:
        kern.launches = 0
    torch.cuda.synchronize()
    out = run_query()
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in counted}
    if launches["compact"] <= 0:
        raise AssertionError("the compute-tail query launched no K2")
    kh, vh, fh = (c.data.cpu().numpy() for c in (key, v, f))
    keep = f.mask().cpu().numpy() & np.isin(kh, members) & \
        v.mask().cpu().numpy()
    vf = torch.cat([b["vf"].data for b in out.batches]).cpu().numpy()
    f0 = torch.cat([b["f0"].data for b in out.batches]).cpu().numpy()
    if not (np.array_equal(vf, vh[keep].astype(np.float64)) and
            np.array_equal(f0.view(np.int64), fh[keep].view(np.int64))):
        raise AssertionError("the compute-tail query differs from numpy")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_query()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"compute-tail query through query() over {len(batches)} "
          f"batches: {int(keep.sum())} rows, equal to numpy; wall "
          f"{statistics.median(walls) * 1e3:.3f} ms (median of 3); "
          f"launches {launches}; phase {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)
    return launches


def _wall_ms(fn):
    """One call's wall time, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_strings(pt, dev, counted):
    """Every string name (73, ``arrow1_tpu_torch.compute_strings.CALLS``)
    once on the card over STRING_ROWS-row dictionary columns from a seed:
    TPC-H's l_shipmode (7 values) and SF10's c_name (SF10_CUSTOMERS
    distinct ``Customer#%09d``, 1% null). The device-routed names (the
    byte matrix) run on both columns, the host-routed ones on a c_name
    over SF1_CUSTOMERS values. Each call's wall time is printed, and its
    output is held against the same call on CPU tensors over the first
    STRING_WINDOW rows, exactly. Each pool's byte-matrix build is timed
    first. Then one query() over STRING_BATCHES 2^20-row batches: filter
    starts_with(c_name, "Customer#0000") & (l_shipmode == "AIR"), project
    utf8_length(c_name) and ascii_lower(l_shipmode), against numpy; its
    K2 launches are counted (set to 0 before, read after) and must be
    above 0. Returns the launches."""
    from arrow1_tpu_torch import compute_strings as cs
    from arrow1_tpu_torch.ops.strings_device import byte_matrix

    t_phase = time.perf_counter()
    big = cs.tpch_string_columns(STRING_ROWS, dev, SF10_CUSTOMERS, seed=0)
    sf1 = cs.tpch_string_columns(STRING_ROWS, dev, SF1_CUSTOMERS, seed=1)
    sets = {"l_shipmode": dict(big, s=big["t"], a=big["t"]),
            "c_name": big, "c_name_sf1": sf1}
    windows = {label: cs.on_device(cols, "cpu", STRING_WINDOW)
               for label, cols in sets.items()}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    matrix_ms = {}
    for label, cols in sets.items():
        _, matrix_ms[label] = _wall_ms(
            lambda d=cols["s"].dictionary: byte_matrix(d, dev))
    print("strings: byte-matrix build per pool (ms, one call): "
          + ", ".join(f"{label} ({len(cols['s'].dictionary)} values) "
                      f"{matrix_ms[label]:.3f}"
                      for label, cols in sets.items()), flush=True)
    failures, times = [], {}
    for name in cs.CALLS:
        labels = ("l_shipmode", "c_name") if cs.route(name) == "device" \
            else ("c_name_sf1",)
        for label in labels:
            out, ms = _wall_ms(lambda: cs.call(name, sets[label]))
            first = out.columns[0] if isinstance(out, pt.RecordBatch) \
                else out
            if first.device.type != "cuda" or \
                    first.length != STRING_ROWS:   # a struct result too
                failures.append(f"{name} on {label}: ran on "
                                f"{first.device}, {first.length} rows")
                continue
            times[name, label] = ms
            problem = cs.same_result(out, cs.call(name, windows[label]),
                                     rows=STRING_WINDOW)
            if problem:
                failures.append(f"{name} on {label}: {problem}")
    if failures:
        raise AssertionError("strings: " + "; ".join(failures))
    calls_s = time.perf_counter() - t_phase - build_s
    for label in sets:
        row = sorted((n, t) for (n, lb), t in times.items() if lb == label)
        if row:
            print(f"strings on {label}, {STRING_ROWS} rows, card wall ms "
                  "(one call): " + ", ".join(f"{n} {t:.3f}" for n, t in row),
                  flush=True)
    print(f"strings: {len({n for n, _ in times})} names, {len(times)} calls "
          f"on the card, each equal to the CPU over the first "
          f"{STRING_WINDOW} rows (columns built in {build_s:.1f} s, calls "
          f"and checks {calls_s:.1f} s)", flush=True)

    # the query layer: a string filter and projection
    rows = STRING_BATCHES << 20
    c_name, mode = big["s"].slice(0, rows), big["t"].slice(0, rows)
    table = pt.Table.from_batches([
        pt.RecordBatch((c_name.slice(lo, 1 << 20), mode.slice(lo, 1 << 20)),
                       ("c_name", "l_shipmode"))
        for lo in range(0, rows, 1 << 20)])

    def run_query():
        return (pt.query(table)
                .filter(pt.call("starts_with", [pt.field("c_name")],
                                pattern="Customer#0000")
                        & (pt.field("l_shipmode") == "AIR"))
                .project([pt.call("utf8_length", [pt.field("c_name")]),
                          pt.call("ascii_lower", [pt.field("l_shipmode")])],
                         ["name_length", "mode"])
                .to_table())

    for kern in counted:
        kern.launches = 0
    out, first_ms = _wall_ms(run_query)
    launches = {kern.__name__: kern.launches for kern in counted}
    if launches["compact"] <= 0:
        raise AssertionError("the string query launched no K2")
    names = c_name.dictionary.values
    starts = np.array([v.startswith("Customer#0000") for v in names])
    codes = c_name.data.cpu().numpy()
    keep = c_name.mask().cpu().numpy() & starts[codes] & \
        (cs.SHIPMODES[mode.data.cpu().numpy()] == "AIR")
    lengths = torch.cat([b["name_length"].data for b in out.batches])
    modes = np.concatenate([b["mode"].to_numpy() for b in out.batches])
    want_len = np.array([len(v) for v in names])[codes[keep]]
    if not (out.num_rows == int(keep.sum()) and np.array_equal(
            lengths.cpu().numpy(), want_len) and bool(np.all(modes == "air"))):
        raise AssertionError("the string query differs from numpy")
    walls = []
    for _ in range(3):
        _, ms = _wall_ms(run_query)
        walls.append(ms)
    print(f"string query through query() over {STRING_BATCHES} batches: "
          f"{int(keep.sum())} rows, equal to numpy; wall "
          f"{statistics.median(walls):.3f} ms (median of 3; first "
          f"{first_ms:.3f} ms); launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_temporal(pt, dev, counted, lt, want):
    """The temporal slice on the card (phase 16). Part 1: each of its 43
    names (``arrow1_tpu_torch.compute_temporal.CALLS``) once over
    TEMPORAL_ROWS-row columns from a seed (date32 ship dates, timestamps
    over 1969-2030, the same instants in America/New_York, naive wall
    times, strftime/strptime over a pool of TEMPORAL_DISTINCT instants),
    its wall time printed (median of 3 calls after a checked one: one
    call's wall can read the allocator's growth), each map call's
    output held against the same call on CPU tensors over the first
    TEMPORAL_WINDOW rows, tdigest over the window on both, exactly. Part
    2: TPC-H Q1 at SF10 on phase 12's line items with its spec predicate
    on a date32 ship date (l_shipdate <= 1998-09-02), projecting
    year(l_shipdate): grouped by l_returnflag it must equal the numpy
    oracle and the int-days template row for row, grouped by the year the
    numpy oracle; each query's K2 and K3 launches of one run are counted
    (set to 0 before, read after), K2's must be above 0, and its wall
    (median of 3) and peak device memory printed. Part 3:
    assume_timezone -> hour, is_dst, local_timestamp at TEMPORAL_ROWS,
    each against the CPU over the window, with the zone's offset table
    on the card. Returns the launches."""
    from arrow1_tpu_torch import compute_temporal as ct
    from arrow1_tpu_torch import models
    from arrow1_tpu_torch.utils import tzif

    t_phase = time.perf_counter()
    cols = ct.temporal_columns(TEMPORAL_ROWS, dev, distinct=TEMPORAL_DISTINCT)
    window = ct.on_device(cols, "cpu", TEMPORAL_WINDOW)
    window_card = ct.on_device(cols, dev, TEMPORAL_WINDOW)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    failures, times = [], {}
    for label, (_, _, _, kind) in ct.CALLS.items():
        out = ct.call(label, cols)
        first = out.columns[0] if isinstance(out, pt.RecordBatch) else out
        if first.data.device.type != "cuda":
            failures.append(f"{label}: ran on {first.data.device}")
            continue
        times[label] = statistics.median(
            _wall_ms(lambda: ct.call(label, cols))[1] for _ in range(3))
        if kind == "map":
            problem = ct.same_result(out, ct.call(label, window),
                                     rows=TEMPORAL_WINDOW)
        else:
            problem = ct.same_result(ct.call(label, window_card),
                                     ct.call(label, window))
        if problem:
            failures.append(f"{label}: {problem}")
    if failures:
        raise AssertionError("temporal: " + "; ".join(failures))
    calls_s = time.perf_counter() - t_phase - build_s
    names = {ct.CALLS[label][0] for label in times}
    print(f"temporal: {len(names)} names in {len(times)} calls on the card "
          f"at {TEMPORAL_ROWS} rows, each equal to the CPU over the first "
          f"{TEMPORAL_WINDOW} rows (columns built in {build_s:.1f} s, calls "
          f"and checks {calls_s:.1f} s); card wall ms (median of 3): "
          + ", ".join(f"{n} {t:.3f}" for n, t in times.items()), flush=True)

    # part 2: Q1 at SF10 on a date32 ship date
    t0 = time.perf_counter()
    lt32 = _date32_lineitem(pt, lt)

    def q1(key, aggs):
        return _q1_date32(pt, lt32, key, aggs)

    queries = [
        ("by l_returnflag", "q1_spec", lambda: q1(
            "l_returnflag", [("l_quantity", "sum"),
                             ("l_extendedprice", "sum"),
                             ("l_quantity", "count")])),
        ("by year(l_shipdate)", "q1_years", lambda: q1(
            "l_year", [("l_quantity", "sum"), ("l_quantity", "count")]))]
    template = models.q1_pricing_summary(lt, Q1_CUTOFF)
    launches = {kern.__name__: 0 for kern in counted}
    for label, oracle, run in queries:
        run()   # warm-up (uncounted)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in counted:
            kern.launches = 0
        out = run()
        torch.cuda.synchronize()
        mem = torch.cuda.max_memory_allocated()
        run_launches = {kern.__name__: kern.launches for kern in counted}
        for name, count in run_launches.items():
            launches[name] += count
        if run_launches["compact"] <= 0:
            raise AssertionError(f"Q1 date32 {label}: the date filter "
                                 "launched no K2")
        _check_sf10(out, want[oracle], f"Q1 date32 {label}")
        if oracle == "q1_spec":   # the int-days template, row for row
            for name in template.names:
                g, w = out[name].to_numpy(), template[name].to_numpy()
                if g.dtype.kind == "f":
                    g, w = g.view(np.int64), w.view(np.int64)
                if g.tolist() != w.tolist():
                    raise AssertionError(f"Q1 date32: {name} {g} differs "
                                         f"from the int-days template {w}")
        walls = [_wall_ms(run)[1] for _ in range(3)]
        print(f"TPC-H SF10 Q1 on date32 l_shipdate <= 1998-09-02, "
              f"{label}: {out.num_rows} groups, equal to the numpy oracle"
              + (" and the int-days template" if oracle == "q1_spec" else "")
              + f"; wall {statistics.median(walls):.3f} ms (median of 3), "
              f"peak device memory {mem / 2**30:.2f} GiB; one run: K2 "
              f"{run_launches['compact']}, K3 "
              f"{run_launches['segment_sums']}", flush=True)
        del out
    del lt32, template
    q1_s = time.perf_counter() - t0

    # part 3: a time zone at full size, its offset table on the card
    wall = cols["wall"]
    opts = dict(timezone=ct.ZONE, ambiguous="earliest",
                nonexistent="earliest")
    z, z_ms = _wall_ms(lambda: pt.call_function("assume_timezone", [wall],
                                                **opts))
    zw = pt.call_function("assume_timezone", [window["wall"]], **opts)
    problem = ct.same_result(z, zw, rows=TEMPORAL_WINDOW)
    tz_ms = {"assume_timezone": z_ms}
    for name in ("hour", "is_dst", "local_timestamp"):
        out, tz_ms[name] = _wall_ms(lambda: pt.call_function(name, [z]))
        problem = problem or ct.same_result(
            out, pt.call_function(name, [zw]), rows=TEMPORAL_WINDOW)
        if name == "local_timestamp":   # wall times back, but in a gap
            moved = int(((out.data != wall.data) & wall.mask()).sum())
    if problem:
        raise AssertionError(f"temporal time zone: {problem}")
    tables = list(tzif.load_tz(ct.ZONE).devices)
    if not any(d.startswith("cuda") for d in tables):
        raise AssertionError(f"the {ct.ZONE} offset table is not on the "
                             f"card: {tables}")
    print(f"temporal time zone {ct.ZONE} ({len(tzif.load_tz(ct.ZONE).trans)}"
          f" transitions, on the card): assume_timezone -> hour, is_dst, "
          f"local_timestamp at {TEMPORAL_ROWS} rows, each equal to the CPU "
          f"over the first {TEMPORAL_WINDOW} rows; {moved} wall times in a "
          f"DST gap moved; card wall ms (one call): "
          + ", ".join(f"{n} {t:.3f}" for n, t in tz_ms.items())
          + f"; Q1 part {q1_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


DECIMAL_ROWS = 10_000_000            # each decimal column's rows
DECIMAL_WINDOW = 1_000_000           # rows held against the CPU
Q6_DAYS = (8766, 9131)   # [1994-01-01, 1995-01-01) (TPC-H Q6)
NESTED_WINDOW = 1_000_000            # orders (and rows) held against the CPU
NESTED_STRING_ROWS = 10_000_000      # the split family's rows
NESTED_FLAGS = ("A", "N", "R")


def _decimal_lineitem(pt, lt, dev):
    """Phase 12's line items with TPC-H's DECIMAL(15,2) columns: the same
    quantities, prices and discounts times 100, exactly (the prices and
    discounts have two decimals: one rounding of x * 100 gives their
    cents), and l_tax uniform over 0.00-0.08 (TPC-H 4.2.3) from seed 4;
    l_shipdate is date32. Returns the Table and the host int64 arrays
    (flag codes, days, cents) of the oracle."""
    from arrow1_tpu_torch import dtypes as dt
    from arrow1_tpu_torch.ops.decimal import pack

    cents = dt.decimal128(15, 2)
    whole = {name: torch.cat([b[name].data for b in lt.batches])
             for name in ("l_quantity", "l_extendedprice", "l_discount",
                          "l_shipdate_days")}
    n = whole["l_quantity"].shape[0]
    hundred = torch.tensor(100.0, dtype=torch.float64, device=dev)
    ints = {"l_quantity": whole["l_quantity"] * 100,
            "l_extendedprice": torch.round(whole["l_extendedprice"]
                                           * hundred).to(torch.int64),
            "l_discount": torch.round(whole["l_discount"]
                                      * hundred).to(torch.int64),
            "l_tax": torch.from_numpy(np.random.default_rng(4).integers(
                0, 9, n)).to(dev)}
    decs = {k: pack([v, v >> 63], cents, None) for k, v in ints.items()}
    days32 = whole["l_shipdate_days"].to(torch.int32)
    flags = torch.cat([b["l_returnflag"].data for b in lt.batches])
    host = {k: v.cpu().numpy() for k, v in ints.items()}
    host["days"] = whole["l_shipdate_days"].cpu().numpy()
    host["flag"] = flags.cpu().numpy()
    flag = lt.batches[0]["l_returnflag"]
    batches, at = [], 0
    for b in lt.batches:
        k = b.num_rows
        cols = [pt.Column(flags[at:at + k], flag.dtype,
                          dictionary=flag.dictionary),
                pt.Column(days32[at:at + k], dt.date32)]
        cols += [decs[name].slice(at, k) for name in
                 ("l_quantity", "l_extendedprice", "l_discount", "l_tax")]
        batches.append(pt.RecordBatch(tuple(cols), (
            "l_returnflag", "l_shipdate", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax")))
        at += k
    return pt.Table(batches), host, flag.dictionary.values


def _group_sums(idx, ngroups, cols):
    """Exact per-group int64 sums of each array in ``cols`` (a sort, then
    np.add.reduceat: no float on the way) and the counts."""
    order = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=ngroups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    present = counts > 0
    out = {}
    for name, col in cols.items():
        sums = np.zeros(ngroups, dtype=np.int64)
        sums[present] = np.add.reduceat(col[order], starts[present])
        out[name] = [int(x) for x in sums]
    return out, counts


def _half_away(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return -q if num < 0 else q


def _decimal_oracles(host, pool):
    """Q1 (by flag, by year) and Q6 in Python ints from the int64 cents:
    each product fits int64 (at most 1.08e9 a row at scale 6, 6.5e16 a
    sum), the means rounded half away from zero as pyarrow rounds them.
    Each is {column: [unscaled ints]} in the query's group order."""
    days = host["days"]
    keep = days <= Q1_CUTOFF
    qty, price = host["l_quantity"][keep], host["l_extendedprice"][keep]
    disc, tax = host["l_discount"][keep], host["l_tax"][keep]
    disc_price = price * (100 - disc)
    cols = {"l_quantity_sum": qty, "l_extendedprice_sum": price,
            "disc_price_sum": disc_price,
            "charge_sum": disc_price * (100 + tax), "l_discount_sum": disc}
    year = days[keep].astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970
    years, year_idx = np.unique(year, return_inverse=True)
    out = {}
    for label, idx, keys, key_name in (
            ("by flag", host["flag"][keep], list(pool), "l_returnflag"),
            ("by year", year_idx, years.tolist(), "l_year")):
        sums, counts = _group_sums(idx, len(keys), cols)
        present = [g for g in range(len(keys)) if counts[g]]
        want = {k: [v[g] for g in present] for k, v in sums.items()
                if k != "l_discount_sum"}
        for c in ("l_quantity", "l_extendedprice", "l_discount"):
            want[f"{c}_mean"] = [_half_away(sums[f"{c}_sum"][g],
                                            int(counts[g]))
                                 for g in present]
        want["l_quantity_count"] = [int(counts[g]) for g in present]
        want[key_name] = [keys[g] for g in present]
        out[label] = want
    sel = (days >= Q6_DAYS[0]) & (days < Q6_DAYS[1]) & \
        (host["l_discount"] >= 5) & (host["l_discount"] <= 7) & \
        (host["l_quantity"] < 2400)
    out["Q6"] = int((host["l_extendedprice"][sel]
                     * host["l_discount"][sel]).sum())
    return out


_Q1_DECIMAL_AGGS = [("l_quantity", "sum"), ("l_extendedprice", "sum"),
                    ("disc_price", "sum"), ("charge", "sum"),
                    ("l_quantity", "mean"), ("l_extendedprice", "mean"),
                    ("l_discount", "mean"), ("l_quantity", "count")]


def _check_decimal_q1(pt, out, want, label):
    """Every column of a Q1 batch equal to the oracle: decimals by their
    unscaled integers (exactly), and their types (the sums pyarrow's
    decimal128(38, s) / decimal256(76, s), the means the input type)."""
    from arrow1_tpu_torch import dtypes as dt
    from arrow1_tpu_torch.column import unscaled_ints

    types = {"l_quantity_sum": dt.decimal128(38, 2),
             "disc_price_sum": dt.decimal128(38, 4),
             "charge_sum": dt.decimal256(76, 6),
             "l_discount_mean": dt.decimal128(15, 2)}
    for name, values in want.items():
        col = out[name]
        if name in types and col.dtype != types[name]:
            raise AssertionError(f"Q1 decimal {label}: {name} is "
                                 f"{col.dtype}, not {types[name]}")
        got = unscaled_ints(col) if col.dtype.is_decimal else \
            col.to_pylist()
        if got != list(values):
            raise AssertionError(f"Q1 decimal {label}: {name} {got[:4]} "
                                 f"!= the oracle's {list(values)[:4]}")


def phase_decimal(pt, dev, counted, lt):
    """The decimal slice on the card (phase 17). Part 1: each call of
    ``arrow1_tpu_torch.compute_decimal.CALLS`` once over DECIMAL_ROWS-row
    columns from a seed (decimal128(15, 2) prices and discounts,
    decimal128(38, 10) across the 2^64 limb boundary, decimal256(60, 6),
    1% null), its wall time printed (median of 3 after a checked call),
    each map call's output held against the same call on CPU tensors over
    the first DECIMAL_WINDOW rows, each aggregate over the window on
    both, exactly. Part 2: TPC-H Q1 at SF10 over phase 12's line items
    with DECIMAL(15,2) quantity, price, discount and tax (the same numbers
    times 100; tax from its own seed) and a date32 ship date: the filter
    l_shipdate <= 1998-09-02, sum_disc_price = sum(price * (1 - disc)),
    sum_charge = sum(cast(price * (1 - disc), decimal256(38, 4)) * (1 +
    tax)) and the means, grouped by l_returnflag (the sorted path) and by
    year(l_shipdate) (an int64 key: the dense path, K3), each equal to an
    exact oracle in Python ints; then Q6 (1994, discount 0.05-0.07,
    quantity < 24, sum(price * disc)) exactly. Each query's K2 and K3
    launches of one run are counted (set to 0 before, read after): K2's
    must be above 0 in each, K3's in the by-year query; its wall (median
    of 3) and peak device memory are printed. Returns the launches."""
    from decimal import Decimal

    from arrow1_tpu_torch import compute_decimal as cd
    from arrow1_tpu_torch import dtypes as dt

    t_phase = time.perf_counter()
    cols = cd.decimal_columns(DECIMAL_ROWS, dev)
    window = cd.on_device(cols, "cpu", DECIMAL_WINDOW)
    window_card = cd.on_device(cols, dev, DECIMAL_WINDOW)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    failures, times = [], {}
    for label, (_, _, _, kind) in cd.CALLS.items():
        out = cd.call(label, cols)
        first = out.columns[0] if isinstance(out, pt.RecordBatch) else out
        if hasattr(first, "data") and first.data.device.type != "cuda":
            failures.append(f"{label}: ran on {first.data.device}")
            continue
        times[label] = statistics.median(
            _wall_ms(lambda: cd.call(label, cols))[1] for _ in range(3))
        ulps = cd.ULPS.get(label, 0)
        if kind == "map":
            problem = cd.same_result(out, cd.call(label, window),
                                     rows=DECIMAL_WINDOW, ulps=ulps)
        else:
            problem = cd.same_result(cd.call(label, window_card),
                                     cd.call(label, window), ulps=ulps)
        if problem:
            failures.append(f"{label}: {problem}")
    del cols, window, window_card
    calls_s = time.perf_counter() - t_phase - build_s
    print(f"decimal: {len(times)} calls on the card at {DECIMAL_ROWS} rows, "
          f"{len(times) - len(failures)} equal to the CPU over the first "
          f"{DECIMAL_WINDOW} rows (columns built in {build_s:.1f} s, calls "
          f"and checks {calls_s:.1f} s); card wall ms (median of 3): "
          + ", ".join(f"{n} {t:.3f}" for n, t in times.items()), flush=True)
    if failures:
        raise AssertionError("decimal: " + "; ".join(failures))

    # part 2: Q1 and Q6 at SF10 on DECIMAL(15,2)
    t0 = time.perf_counter()
    ld, host, pool = _decimal_lineitem(pt, lt, dev)
    want = _decimal_oracles(host, pool)
    del host
    cents = dt.decimal128(15, 2)
    one = pt.scalar(Decimal("1.00"), cents)
    f = pt.field
    disc_price = pt.call("multiply", [f("l_extendedprice"), pt.call(
        "subtract", [one, f("l_discount")])])
    charge = pt.call("multiply", [
        pt.call("cast", [disc_price], target_type=dt.decimal256(38, 4)),
        pt.call("add", [one, f("l_tax")])])

    def q1(key):
        return (pt.query(ld)
                .filter(f("l_shipdate") <= pt.scalar(Q1_CUTOFF, dt.date32))
                .project([f("l_returnflag"), f("l_quantity"),
                          f("l_extendedprice"), f("l_discount"), disc_price,
                          charge, pt.call("year", [f("l_shipdate")])],
                         ["l_returnflag", "l_quantity", "l_extendedprice",
                          "l_discount", "disc_price", "charge", "l_year"])
                .group_by([key], _Q1_DECIMAL_AGGS)
                .order_by([(key, "ascending")])
                .to_batch())

    def q6():
        t = (pt.query(ld)
             .filter((f("l_shipdate") >= pt.scalar(Q6_DAYS[0], dt.date32))
                     & (f("l_shipdate") < pt.scalar(Q6_DAYS[1], dt.date32))
                     & (f("l_discount") >= pt.scalar(Decimal("0.05"), cents))
                     & (f("l_discount") <= pt.scalar(Decimal("0.07"), cents))
                     & (f("l_quantity") < pt.scalar(Decimal("24"), cents)))
             .project([pt.call("multiply", [f("l_extendedprice"),
                                            f("l_discount")])], ["revenue"])
             .to_table())
        return pt.call_function("sum", [pt.concat_columns(
            [b["revenue"] for b in t.batches])])

    queries = [("Q1 by l_returnflag", lambda: q1("l_returnflag"),
                "by flag"),
               ("Q1 by year(l_shipdate)", lambda: q1("l_year"), "by year"),
               ("Q6", q6, "Q6")]
    launches = {kern.__name__: 0 for kern in counted}
    for label, run, oracle in queries:
        run()   # warm-up (uncounted)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in counted:
            kern.launches = 0
        out = run()
        torch.cuda.synchronize()
        mem = torch.cuda.max_memory_allocated()
        run_launches = {kern.__name__: kern.launches for kern in counted}
        for name, count in run_launches.items():
            launches[name] += count
        if run_launches["compact"] <= 0:
            raise AssertionError(f"decimal {label}: the filter launched no "
                                 "K2")
        if oracle == "by year" and run_launches["segment_sums"] <= 0:
            raise AssertionError(f"decimal {label}: the dense group_by "
                                 "launched no K3")
        if oracle == "Q6":
            if out.dtype != dt.decimal128(38, 4) or \
                    out.value != want["Q6"]:
                raise AssertionError(f"decimal Q6: {out!r} != the oracle's "
                                     f"{want['Q6']} (scale 4)")
            groups = 1
        else:
            _check_decimal_q1(pt, out, want[oracle], label)
            groups = out.num_rows
        walls = [_wall_ms(run)[1] for _ in range(3)]
        print(f"TPC-H SF10 {label} on DECIMAL(15,2)"
              + (" (sum_charge in decimal256)" if oracle != "Q6" else "")
              + f": {groups} groups, equal to the exact oracle; "
              f"wall {statistics.median(walls):.3f} ms (median of 3), peak "
              f"device memory {mem / 2**30:.2f} GiB; one run: K2 "
              f"{run_launches['compact']}, K3 "
              f"{run_launches['segment_sums']}", flush=True)
        del out
    print(f"decimal: Q1/Q6 part {time.perf_counter() - t0:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches



def _nested_steps(pt):
    """The calls of the nested phase, in order: (label, kind, call). Each
    call takes the namespace ``d`` (the line items ``li``, the first
    rows ``head``, the string columns ``str`` and the earlier results
    by label) and returns its result. ``kind`` says how a card result is
    held against the CPU's: "orders" over the orders of the window (the
    CPU runs over the line items of the first NESTED_WINDOW orders, whose
    results are the card's first rows), "rows" over the first
    NESTED_WINDOW line items or string rows, "whole" on the first
    NESTED_WINDOW line items on both (its result is per group)."""
    call = pt.call_function

    def lists(name):
        return lambda d: call("hash_list", [d["li"][name],
                                            d["li"]["l_orderkey"]])

    def orders_map(d):   # map<string, int64>: each order's flag -> qty
        qty, flag = d["qty_lists"], d["flag_lists"]
        return pt.ListColumn(qty.offsets, pt.RecordBatch(
            (flag.values, qty.values), ("key", "value")),
            pt.map_(pt.string, pt.int64))

    def orders_batch(d):
        n = d["qty_lists"].length
        return pt.RecordBatch((
            pt.Column(torch.arange(n, device=d["qty_lists"].device),
                      pt.int64), d["qty_lists"], d["price_lists"]),
            ("o_orderkey", "l_quantity", "l_extendedprice"))

    def long_orders(d):   # a K2 filter of a batch with list columns
        batch = orders_batch(d)
        more = call("greater", [call("list_value_length",
                                     [batch["l_quantity"]]),
                                pt.scalar(4, pt.int32)])
        return call("filter", [batch, more])

    def lineitem_struct(d):
        h = d["head"]
        return call("make_struct", [h["l_quantity"], h["l_extendedprice"],
                                    h["l_returnflag"]],
                    field_names=("l_quantity", "l_extendedprice",
                                 "l_returnflag")).to_struct_array()

    def by_flag(d):
        h = d["head"]
        return call("hash_tdigest", [h["l_extendedprice"], pt.Column(
            h["l_returnflag"].data, pt.int32)], q=(0.5, 0.9))

    return [
        ("hash_list(l_quantity)", "orders", "qty_lists",
         lists("l_quantity")),
        ("hash_list(l_extendedprice)", "orders", "price_lists",
         lists("l_extendedprice")),
        ("hash_list(l_returnflag)", "orders", "flag_lists",
         lists("l_returnflag")),
        ("list_value_length", "orders", None, lambda d: call(
            "list_value_length", [d["qty_lists"]])),
        ("list_flatten", "orders", "flat", lambda d: call(
            "list_flatten", [d["qty_lists"]])),
        ("list_parent_indices", "orders", "parents", lambda d: call(
            "list_parent_indices", [d["qty_lists"]])),
        ("list_slice(1, 3)", "orders", None, lambda d: call(
            "list_slice", [d["price_lists"]], start=1, stop=3)),
        ("filter(list_value_length > 4)", "orders", "long", long_orders),
        ("list_element(0)", "orders", None, lambda d: call(
            "list_element", [d["long"]["l_extendedprice"]], index=0)),
        ("hash_distinct(l_returnflag)", "orders", None, lambda d: call(
            "hash_distinct", [d["li"]["l_returnflag"],
                              d["li"]["l_orderkey"]])),
        ("map_lookup(R, first)", "orders", None, lambda d: call(
            "map_lookup", [orders_map(d)], query_key="R",
            occurrence="first")),
        ("map_lookup(R, last)", "orders", None, lambda d: call(
            "map_lookup", [orders_map(d)], query_key="R",
            occurrence="last")),
        ("map_lookup(R, all)", "orders", None, lambda d: call(
            "map_lookup", [orders_map(d)], query_key="R",
            occurrence="all")),
        ("make_struct", "rows", "struct", lineitem_struct),
        ("struct_field(l_extendedprice)", "rows", "price", lambda d: call(
            "struct_field", [d["struct"]], field="l_extendedprice")),
        ("hash_tdigest(l_extendedprice by l_returnflag)", "whole", None,
         by_flag),
        ("split_pattern(c_name, #)", "rows", "name_parts", lambda d: call(
            "split_pattern", [d["str"]["s"]], pattern="#")),
        ("binary_join(c_name parts, #)", "rows", "name_joined",
         lambda d: call("binary_join", [d["name_parts"], pt.scalar("#")])),
        ("ascii_split_whitespace(l_shipmode)", "rows", "mode_parts",
         lambda d: call("ascii_split_whitespace", [d["str"]["t"]])),
        ("binary_join(l_shipmode parts, ' ')", "rows", "mode_joined",
         lambda d: call("binary_join", [d["mode_parts"], pt.scalar(" ")])),
        ("utf8_split_whitespace(l_shipmode)", "rows", "mode_parts8",
         lambda d: call("utf8_split_whitespace", [d["str"]["t"]])),
        ("binary_join(utf8 parts, ' ')", "rows", "mode_joined8",
         lambda d: call("binary_join", [d["mode_parts8"], pt.scalar(" ")])),
    ]


def _same_strings(got, want) -> bool:
    """Two string columns hold the same values and nulls (their pools may
    differ): the result's codes mapped into the input's pool, on the
    card."""
    index = want.dictionary.index
    remap = torch.tensor([index.get(v, -1) for v in got.dictionary.values],
                         dtype=torch.int64).to(got.data.device)
    codes = remap[got.data.to(torch.int64)] if len(remap) else \
        got.data.to(torch.int64)
    gm, wm = got.mask(), want.mask()
    return bool(torch.equal(gm, wm)) and bool(
        (torch.where(wm, codes, 0) ==
         torch.where(wm, want.data.to(torch.int64), 0)).all())


def _pivot_oracle(days, flags, qty):
    """Exact sums of l_quantity by (ship year, l_returnflag) in numpy:
    {year: [A, N, R]} (None where the pair has no row)."""
    years = (np.datetime64("1970-01-01", "D") + days).astype(
        "datetime64[Y]").astype(np.int64) + 1970
    y0 = int(years.min())
    slot = (years - y0) * 3 + flags
    size = (int(years.max()) - y0 + 1) * 3
    sums = np.bincount(slot, weights=qty, minlength=size)
    counts = np.bincount(slot, minlength=size)
    return {y0 + i: [int(sums[3 * i + f]) if counts[3 * i + f] else None
                     for f in range(3)] for i in range(size // 3)}


def phase_nested(pt, dev, counted, lt):
    """The nested slice on the card (phase 19). Phase 12's SF10 line items
    (59,986,052 rows, l_orderkey uniform over 15M orders) nested under
    their orders: hash_list of l_quantity, l_extendedprice and
    l_returnflag by l_orderkey (15M lists of ~4 items), then over them
    list_value_length, list_flatten, list_parent_indices, list_slice(1,
    3), a filter of the orders batch that holds the list columns (list
    length > 4: K2 moves the flat column and the kept rows' numbers, the
    list columns are gathered by them), list_element(0) of the kept
    lists, hash_distinct(l_returnflag) by order, a map<string, int64> of
    each order's flags to quantities and map_lookup("R") with first, last
    and all; make_struct and struct_field over the line items;
    hash_tdigest of l_extendedprice by l_returnflag at q = (0.5, 0.9);
    split_pattern(c_name, "#") and the whitespace splits of l_shipmode
    over NESTED_STRING_ROWS rows of compute_strings' TPC-H columns, each
    joined back by binary_join. Each call's wall (median of 3, the first
    one's result kept) is printed, and its result held against the same
    call on CPU tensors (``compute_nested.same_nested``): exactly, over
    the first NESTED_WINDOW orders (the CPU's input: their line items) or
    rows. At full size: the lengths sum to the line items, the flattened
    lists are l_quantity in l_orderkey order, the parent indices the
    sorted keys, struct_field gives l_extendedprice back bit for bit, and
    every binary_join gives its split's input back. Then a group_by on
    (year(l_shipdate), l_returnflag) summing l_quantity, pivoted wide by
    flag (hash_pivot_wider by year; pivot_wider of the first year),
    against an exact numpy oracle. The K2 and K3 launches of the card's
    calls are counted (set to 0 before, read after): K2's must be above
    0. Prints the peak device memory. Returns the launches."""
    from arrow1_tpu_torch import compute_strings as cs
    from arrow1_tpu_torch import dtypes as dt
    from arrow1_tpu_torch.compute_nested import move, same_nested

    t_phase = time.perf_counter()
    names = ("l_orderkey", "l_quantity", "l_extendedprice", "l_returnflag",
             "l_shipdate_days")
    li = pt.concat_batches([b.select(names) for b in lt.batches])
    n_li = li.num_rows
    strs = cs.tpch_string_columns(NESTED_STRING_ROWS, dev, SF10_CUSTOMERS,
                                  seed=0)
    # the CPU's inputs: the line items of the first NESTED_WINDOW orders,
    # the first NESTED_WINDOW line items and string rows
    in_window = pt.call_function("less", [li["l_orderkey"], pt.scalar(
        NESTED_WINDOW)])
    cpu = {"li": move(pt.call_function("filter", [li, in_window]), "cpu"),
           "head": move(li.slice(0, NESTED_WINDOW), "cpu"),
           "str": {k: move(c.slice(0, NESTED_WINDOW), "cpu")
                   for k, c in strs.items()}}
    card = {"li": li, "head": li, "str": strs}
    card_head = {"li": li.slice(0, NESTED_WINDOW),
                 "head": li.slice(0, NESTED_WINDOW), "str": strs}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    for kern in counted:
        kern.launches = 0
    failures, walls = [], {}
    steps = _nested_steps(pt)
    for label, kind, key, fn in steps:
        out, first = _wall_ms(lambda: fn(card))
        walls[label] = statistics.median(
            [first] + [_wall_ms(lambda: fn(card))[1] for _ in range(2)])
        if key:
            card[key] = out
        want = fn(cpu)
        if key:
            cpu[key] = want
        if kind == "whole":
            out = fn(card_head)
        where = (out.columns[0] if isinstance(out, pt.RecordBatch)
                 else out).device
        if where.type != torch.device(dev).type:
            failures.append(f"{label}: ran on {where}")
            continue
        rows = None if kind == "whole" else (
            want.num_rows if isinstance(want, pt.RecordBatch)
            else want.length)
        problem = same_nested(move(out, "cpu"), want, rows)
        if problem:
            failures.append(f"{label}: {problem}")
    launches = {kern.__name__: kern.launches for kern in counted}
    if failures:
        raise AssertionError("nested: " + "; ".join(failures))

    # at full size, on the card
    key = li["l_orderkey"].data
    order = torch.sort(key, stable=True)
    qty_lists = card["qty_lists"]
    lengths = pt.call_function("list_value_length", [qty_lists])
    checks = {
        "lengths sum to the line items":
            int(lengths.data.sum()) == n_li == qty_lists.values.length,
        "list_flatten is l_quantity in l_orderkey order": torch.equal(
            card["flat"].data, li["l_quantity"].data[order.indices]),
        "list_parent_indices are the sorted keys": torch.equal(
            card["parents"].data, order.values),
        "struct_field gives l_extendedprice back": torch.equal(
            card["price"].data.view(torch.int64),
            li["l_extendedprice"].data.view(torch.int64)),
        "binary_join gives c_name back": _same_strings(
            card["name_joined"], strs["s"]),
        "binary_join gives l_shipmode back": _same_strings(
            card["mode_joined"], strs["t"]),
        "binary_join of the utf8 split gives l_shipmode back":
            _same_strings(card["mode_joined8"], strs["t"]),
    }
    bad = [label for label, ok in checks.items() if not ok]
    if bad:
        raise AssertionError("nested at full size: " + "; ".join(bad))
    del order, lengths

    # Q1's report pivoted wide: sum(l_quantity) by (ship year, flag)
    flag = li["l_returnflag"]
    year = pt.call_function("year", [pt.Column(
        li["l_shipdate_days"].data.to(torch.int32), dt.date32)])
    for kern in counted:
        kern.launches = 0
    t0 = time.perf_counter()
    grouped = pt.group_by(pt.RecordBatch(
        (year, flag, li["l_quantity"]), ("year", "l_returnflag",
                                         "l_quantity")),
        ["year", "l_returnflag"], [("l_quantity", "sum")])
    first_year = int(grouped["year"].data.min())
    wide = pt.call_function("hash_pivot_wider", [
        grouped["l_returnflag"], grouped["l_quantity_sum"], pt.Column(
            grouped["year"].data - first_year, pt.int64)],
        key_names=NESTED_FLAGS)
    one = pt.call_function("filter", [grouped, pt.call_function(
        "equal", [grouped["year"], pt.scalar(first_year)])])
    row = pt.call_function("pivot_wider", [one["l_returnflag"],
                                           one["l_quantity_sum"]],
                           key_names=NESTED_FLAGS)
    torch.cuda.synchronize()
    pivot_ms = (time.perf_counter() - t0) * 1e3
    for kname, count in ((k.__name__, k.launches) for k in counted):
        launches[kname] += count
    host = {c: li[c].data.cpu().numpy() for c in
            ("l_shipdate_days", "l_quantity")}
    want = _pivot_oracle(host["l_shipdate_days"],
                         flag.data.cpu().numpy().astype(np.int64),
                         host["l_quantity"])
    codes = {v: i for i, v in enumerate(flag.dictionary.values)}
    got = {first_year + i: [wide[f].to_pylist()[i] for f in NESTED_FLAGS]
           for i in range(wide.num_rows)}
    want = {y: [vals[codes[f]] for f in NESTED_FLAGS]
            for y, vals in want.items()}
    if got != want or [row[f].to_pylist()[0] for f in NESTED_FLAGS] != \
            want[first_year]:
        raise AssertionError("nested: the pivoted Q1 report differs from "
                             "numpy")
    mem = torch.cuda.max_memory_allocated()
    if launches["compact"] <= 0:
        raise AssertionError("the nested phase launched no K2")
    print(f"nested: {qty_lists.length} orders' lists over {n_li} line items "
          f"and {NESTED_STRING_ROWS} string rows; {len(steps)} calls on the "
          f"card, each equal to the CPU over the first {NESTED_WINDOW} "
          f"orders or rows; full-size checks held ({', '.join(checks)}); "
          f"inputs built in {build_s:.1f} s", flush=True)
    print("nested: card wall ms (median of 3): " + ", ".join(
        f"{label} {ms:.3f}" for label, ms in walls.items()), flush=True)
    print(f"nested: Q1's quantities by (year, flag) pivoted wide, "
          f"{wide.num_rows} years x {len(NESTED_FLAGS)} flags, equal to "
          f"numpy; group_by + hash_pivot_wider + pivot_wider wall "
          f"{pivot_ms:.3f} ms (one call); peak device memory "
          f"{mem / 2**30:.2f} GiB; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_probe_device_times(device_calls, rows):
    """Device time per call of each probe, of its library call and of the
    empty kernel behind the same operator path, from torch.profiler's
    kernel records. It runs after every other phase: the profiler's CUDA
    tracing may stay attached to the process and slow the launches that
    follow it. Also checks that the probes went through the dispatcher:
    the profiler records their a1t:: operators."""
    from arrow1_tpu_torch.kernels import probes

    for name, (run, lib) in device_calls.items():
        r = rows.setdefault(name, {})
        r["device_us"], names, ops = _device_us(run)
        op = "a1t::" + (probes.PROBES[name][0] if name in probes.PROBES
                        else probes.EMPTY)
        if op not in ops:
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
    days = li["l_shipdate_days"]
    keep = days <= Q1_CUTOFF
    fl = flag_codes[keep]
    out["q1_spec"] = dict(
        l_quantity_sum=np.bincount(fl, weights=qty[keep], minlength=3)
        .astype(np.int64),
        l_extendedprice_sum=np.bincount(fl, weights=price[keep],
                                        minlength=3),
        l_quantity_count=np.bincount(fl, minlength=3),
        l_returnflag=flag_pool)
    year = days[keep].astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970
    years, year_idx = np.unique(year, return_inverse=True)
    out["q1_years"] = dict(
        l_quantity_sum=np.bincount(year_idx, weights=qty[keep])
        .astype(np.int64),
        l_quantity_count=np.bincount(year_idx), l_year=years)
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
    """Stands in for ``ops.join._build_table`` and counts its calls (each
    builds a hash table)."""

    def __init__(self, real):
        self.real = real
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs)


def phase_sf10(pt, dev, peak, counted):
    """The query layer at TPC-H SF10 cardinalities. Returns the launch
    counts of the counted runs, the lineitem Table and the orders batch
    (phases 16, 17, 19 and 20 reuse them) and the numpy oracles."""
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
        counter = _CallCounter(ops_join._build_table)
        ops_join._build_table = counter
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            ops_join._build_table = counter.real
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
              f"{run_launches['segment_sums']}, hash-join builds "
              f"{counter.calls}", flush=True)
        if oracle in ("q3", "q5") and counter.calls != \
                {"q3": 1, "q5": 2}[oracle]:
            raise AssertionError(f"{label}: {counter.calls} hash-join "
                                 "builds, not one a join")
    return launches, lt, ob, want


DIST_AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
             ("w", "sum"), ("w", "mean")]


def _dist_batch(pt, dev, G):
    """Config 2's 10M rows at G keys (seed 0) with a row id ``i``."""
    k, v, w, w_valid = _group_by_data(G)
    batch = pt.record_batch({"k": k, "v": v,
                             "i": np.arange(N_BIG, dtype=np.int64)},
                            device=dev)
    wcol = pt.Column(torch.from_numpy(w).to(dev), pt.int32,
                     validity=torch.from_numpy(w_valid).to(dev))
    return pt.RecordBatch(batch.columns + (wcol,), batch.names + ("w",))


def _same_batch(got, want, label, by=None, approx=()):
    """Equal columns: data and validity exactly (f64 columns named in
    ``approx`` within SF10_RTOL relative); with ``by``, both sides' rows
    first put in the order of that unique int64 column."""
    if list(got.names) != list(want.names) or got.num_rows != want.num_rows:
        raise AssertionError(f"{label}: {got!r} vs {want!r}")

    def order(b):
        return None if by is None else torch.argsort(b[by].data)

    og, ow = order(got), order(want)
    for name in want.names:
        a, b = got[name], want[name]
        da, db = (a.data, b.data) if by is None else (a.data[og],
                                                      b.data[ow])
        va, vb = (a.mask(), b.mask()) if by is None else (a.mask()[og],
                                                          b.mask()[ow])
        if not torch.equal(va, vb):
            raise AssertionError(f"{label}: column {name}'s nulls differ")
        if name in approx:
            ok = torch.allclose(da[va], db[vb], rtol=SF10_RTOL, atol=0)
        else:
            ok = torch.equal(torch.where(va, da, 0), torch.where(vb, db, 0))
        if not ok:
            raise AssertionError(f"{label}: column {name} differs")


def phase_distributed(pt, dev, counted, lt, ob, want):
    """Phase 20: the distributed operators and the distributed TPC-H
    templates on a one-rank NCCL group on the card, each against the
    single-card engine's answer on the same input. Returns the launch
    counts of the counted runs."""
    from arrow1_tpu_torch import models
    from arrow1_tpu_torch.exec.plan import sort_batch
    from arrow1_tpu_torch.parallel import (dist_filter, dist_group_by,
                                           dist_join, make_mesh, multihost)
    from arrow1_tpu_torch.parallel.distributed import dist_sort
    from arrow1_tpu_torch.parallel.shuffle import EXCHANGED

    t_phase = time.perf_counter()
    multihost.initialize(device=dev)   # NCCL, one rank, a HashStore
    try:
        import torch.distributed as dist

        mesh = make_mesh()
        if dist.get_backend() != "nccl" or mesh.device != torch.device(dev):
            raise AssertionError(f"phase 20: backend {dist.get_backend()} "
                                 f"on {mesh.device}, not NCCL on {dev}")
        b1k = _dist_batch(pt, dev, 1000)
        bmg = _dist_batch(pt, dev, 1 << 20)
        dims = pt.record_batch({"k": np.arange(0, 1000, 2, dtype=np.int64),
                                "z": np.arange(0, 3000, 6, dtype=np.int64)},
                               device=dev)
        li = lt.combine_chunks()
        pred = pt.field("v") > 0
        sort_keys = [("k", "ascending"), ("v", "descending")]

        def by_key(b):   # the groups in key order
            return pt.RecordBatch(tuple(pt.take(c, pt.Column(
                torch.argsort(b["k"].data), pt.int64)) for c in b.columns),
                b.names)

        def once(fn):   # the single-card answer, computed at first use
            box = []
            return lambda: box[0] if box else (box.append(fn()) or box[0])

        want_filter = once(lambda: pt.filter(b1k, pred.execute(b1k)))
        want_gb = {G: once(lambda b=b: by_key(pt.group_by(b, ["k"],
                                                          DIST_AGGS)))
                   for G, b in ((1000, b1k), (1 << 20, bmg))}
        want_join = {jt: once(lambda jt=jt: pt.join(b1k, dims, ["k"],
                                                    join_type=jt))
                     for jt in ("inner", "left outer")}
        want_sort = once(lambda: sort_batch(b1k, sort_keys))
        want_q1 = once(lambda: models.q1_pricing_summary(lt))
        want_q3 = once(lambda: models.q3_shipping_priority(lt, ob))
        calls = [
            ("dist_filter 10M", lambda: dist_filter(b1k, pred, mesh),
             lambda out: _same_batch(out, want_filter(), "dist_filter"))]
        for G, b in ((1000, b1k), (1 << 20, bmg)):
            label = f"dist_group_by G={G}"
            calls.append((label, lambda b=b: dist_group_by(
                b, ["k"], DIST_AGGS, mesh),
                lambda out, G=G, label=label: _same_batch(
                    by_key(out), want_gb[G](), label, approx=("w_mean",))))
        for jt in ("inner", "left outer"):
            calls.append((f"dist_join {jt}", lambda jt=jt: dist_join(
                b1k, dims, ["k"], join_type=jt, mesh=mesh),
                lambda out, jt=jt: _same_batch(out, want_join[jt](),
                                               f"dist_join {jt}", by="i")))
        calls += [
            ("dist_sort 10M", lambda: dist_sort(b1k, sort_keys, mesh),
             lambda out: _same_batch(out, want_sort(), "dist_sort")),
            ("q1_distributed SF10", lambda: models.q1_distributed(li, mesh),
             lambda out: (_check_sf10(out, want["q1"], "q1_distributed"),
                          _same_batch(out, want_q1(),
                                      "q1_distributed against query()",
                                      approx=("l_extendedprice_sum",)))),
            ("q3_distributed SF10",
             lambda: models.q3_distributed(li, ob, mesh),
             lambda out: (_check_sf10(out, want["q3"], "q3_distributed"),
                          _same_batch(out, want_q3(),
                                      "q3_distributed against query()",
                                      approx=("l_extendedprice_sum",))))]
        print(f"phase 20: a one-rank NCCL group on {mesh.device}; config 2 "
              f"at {N_BIG} rows, SF10 {li.num_rows} line items and "
              f"{ob.num_rows} orders", flush=True)
        launches = {kern.__name__: 0 for kern in counted}
        for label, run, check in calls:
            check(run())   # warm-up, checked
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in counted:
                kern.launches = 0
            sent = EXCHANGED["bytes"]
            check(run())
            torch.cuda.synchronize()
            mem = torch.cuda.max_memory_allocated()
            sent = EXCHANGED["bytes"] - sent
            run_launches = {kern.__name__: kern.launches for kern in counted}
            for name, count in run_launches.items():
                launches[name] += count
            if run_launches["compact"] <= 0:
                raise AssertionError(f"{label}: no K2 launch")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            print(f"{label}: equals the single-card engine; wall "
                  f"{statistics.median(walls) * 1e3:.3f} ms (median of 3), "
                  f"peak device memory {mem / 2**30:.2f} GiB, "
                  f"all_to_all_single {sent / 1e9:.3f} GB a call, K2 "
                  f"launches {run_launches['compact']}", flush=True)
        del b1k, bmg, li
    finally:
        multihost.shutdown()
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s", flush=True)
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


def _tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _datum_bytes(x) -> int:
    """A flat Column's, a RecordBatch's or a Scalar's tensor bytes, summed
    here without the profiler's walk."""
    if isinstance(x, torch.Tensor):
        return _tensor_bytes(x)
    if hasattr(x, "columns"):
        return sum(_datum_bytes(c) for c in x.columns)
    if hasattr(x, "data"):
        return _tensor_bytes(x.data, x.validity, x.data2)
    return _tensor_bytes(x.value) if isinstance(x.value, torch.Tensor) \
        else 0


def _same_column_bits(got, want, label):
    """Two flat columns bit for bit: data (floats as bits), validity, the
    second data tensor, and the decoded strings (pools may differ in
    order: each code is mapped to the other pool's on the card)."""
    if got.dtype != want.dtype or got.length != want.length:
        raise AssertionError(f"{label}: {got!r} against {want!r}")
    if (got.validity is None) != (want.validity is None) or (
            got.validity is not None and
            not torch.equal(got.validity, want.validity)):
        raise AssertionError(f"{label}: validity differs")
    if (got.data2 is None) != (want.data2 is None) or (
            got.data2 is not None and not torch.equal(got.data2,
                                                      want.data2)):
        raise AssertionError(f"{label}: data2 differs")
    g, w = got.data, want.data
    if got.dictionary is not None:
        index = {v: i for i, v in enumerate(want.dictionary.values.tolist())}
        remap = torch.tensor([index.get(v, -1) for v in
                              got.dictionary.values.tolist()],
                             dtype=torch.int64, device=g.device)
        g = remap[g.to(torch.int64)] if len(remap) else g.to(torch.int64)
        w = w.to(torch.int64)
    g, w = _bits(g), _bits(w)
    if got.validity is not None:   # a null slot's value is not compared
        g, w = (torch.where(got.validity, t, torch.zeros_like(t))
                for t in (g, w))
    if not torch.equal(g, w):
        raise AssertionError(f"{label}: values differ")


def _same_batches(got, want, label):
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} batches, not "
                             f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.names != w.names:
            raise AssertionError(f"{label}: batch {i} columns {g.names}")
        for name in w.names:
            _same_column_bits(g[name], w[name], f"{label} batch {i} {name}")


def _date32_lineitem(pt, table):
    """The line items with l_shipdate, a date32 column made from
    l_shipdate_days (views, but for the int32 copy)."""
    from arrow1_tpu_torch import dtypes as dt

    return pt.Table([b.set_column("l_shipdate", pt.Column(
        b["l_shipdate_days"].data.to(torch.int32), dt.date32))
        for b in table.batches])


def _q1_date32(pt, t32, key, aggs):
    """TPC-H Q1 with the spec's ship-date predicate on the date32 column,
    projecting year(l_shipdate), grouped by ``key`` (by the year: a dense
    integer key, so K3 sums it)."""
    from arrow1_tpu_torch import dtypes as dt

    return (pt.query(t32)
            .filter(pt.field("l_shipdate") <= pt.scalar(Q1_CUTOFF,
                                                        dt.date32))
            .project([pt.field("l_returnflag"), pt.field("l_quantity"),
                      pt.field("l_extendedprice"),
                      pt.call("year", [pt.field("l_shipdate")])],
                     ["l_returnflag", "l_quantity", "l_extendedprice",
                      "l_year"])
            .group_by([key], aggs)
            .order_by([(key, "ascending")])
            .to_batch())


def phase_host_plane(pt, dev, counted, lt, ob, want):
    """Phase 21: the SF10 line items through an Arrow IPC file and back
    into Q1, the prefetch, LZ4 and Feather legs, the profiler and the
    runtime's reports. Returns the launch counts of its counted runs."""
    from arrow1_tpu_torch import (compute, feather, models, native, profiler,
                                  runtime)
    from arrow1_tpu_torch.io import feather1
    from arrow1_tpu_torch.io import ipc as pio
    from arrow1_tpu_torch.io.prefetch import prefetch_batches

    card = _card_line()
    if not native.native_available() or not \
            native.library_path().exists():
        raise AssertionError("the native library was not built from "
                             "native/src")
    launches = {kern.__name__: 0 for kern in counted}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_li = lt.num_rows
    table_bytes = sum(_datum_bytes(b) for b in lt.batches)
    tmp = tempfile.mkdtemp(prefix="a1t-host-plane-")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"host plane: {tmp} has {free} bytes free; the line items "
              f"hold {table_bytes} bytes on the card", flush=True)
        if free < 2 * table_bytes:
            raise AssertionError(f"host plane: {free} bytes free in {tmp}, "
                                 f"fewer than twice the table's "
                                 f"{table_bytes}")
        path = os.path.join(tmp, "lineitem.arrow")

        # 1-2: write, read straight onto the card, Q1 from the file
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pio.write_ipc(lt, path)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        ft = pio.read_ipc(path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        if ft.batches[0]["l_quantity"].device.type != torch.device(dev).type:
            raise AssertionError("read_ipc did not place the batches on "
                                 "the card")
        _same_batches(ft.batches, lt.batches, "IPC file read")
        print(f"host plane: wrote {n_li} line items in "
              f"{len(lt.batches)} batches, {size} bytes, in "
              f"{write_s:.3f} s ({size / write_s / 1e9:.3f} GB/s, page "
              f"cache, not flushed); read onto the card in {read_s:.3f} s "
              f"({size / read_s / 1e9:.3f} GB/s, warm page cache); equal "
              f"to the table bit for bit [{card}]", flush=True)
        in_memory = models.q1_pricing_summary(lt)
        ft32 = _date32_lineitem(pt, ft)
        queries = [("Q1", lambda: models.q1_pricing_summary(ft), "q1"),
                   ("Q1 by year", lambda: _q1_date32(
                       pt, ft32, "l_year", [("l_quantity", "sum"),
                                            ("l_quantity", "count")]),
                    "q1_years")]
        for label, run, oracle in queries:
            run()   # warm-up (uncounted)
            torch.cuda.synchronize()
            for kern in counted:
                kern.launches = 0
            out = run()
            torch.cuda.synchronize()
            run_launches = {kern.__name__: kern.launches for kern in counted}
            for kname, count in run_launches.items():
                launches[kname] += count
            _check_sf10(out, want[oracle], f"host plane {label}")
            if label == "Q1":
                if run_launches["compact"] <= 0:
                    raise AssertionError("host plane Q1 launched no K2")
                for name in in_memory.names:
                    _same_column_bits(out[name], in_memory[name],
                                      f"host plane Q1 {name} against the "
                                      "in-memory table")
            elif run_launches["segment_sums"] <= 0:
                raise AssertionError("host plane Q1 by year launched no K3")
            walls = [_wall_ms(run)[1] for _ in range(3)]
            print(f"host plane: TPC-H SF10 {label} from the IPC file: equal "
                  f"to the numpy oracle"
                  + (" and bit-equal to Q1 over the in-memory table"
                     if label == "Q1" else "")
                  + f"; wall {statistics.median(walls):.3f} ms (median of "
                  f"3); one run: K2 {run_launches['compact']}, K3 "
                  f"{run_launches['segment_sums']} [{card}]", flush=True)
            del out

        # 3: CPU decode in the background, batches moved to the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = list(prefetch_batches(pio.read_ipc(path, batched=True,
                                                 device="cpu"),
                                    readahead=2, device=dev))
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        _same_batches(pre, ft.batches, "prefetch read")
        print(f"host plane: prefetch read (CPU decode, readahead 2, then "
              f"the card) {pre_s:.3f} s ({size / pre_s / 1e9:.3f} GB/s), "
              f"its batches equal the first read's [{card}]", flush=True)
        del pre

        # 4: LZ4 on the first batches
        head = pt.Table(lt.batches[:HOST_PLANE_LZ4_BATCHES])
        plain_path = os.path.join(tmp, "head.arrow")
        lz4_path = os.path.join(tmp, "head.lz4.arrow")
        pio.write_ipc(head, plain_path)
        t0 = time.perf_counter()
        pio.write_ipc(head, lz4_path, compression="lz4")
        lz4_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = pio.read_ipc(lz4_path)
        torch.cuda.synchronize()
        lz4_read_s = time.perf_counter() - t0
        _same_batches(back.batches, head.batches, "LZ4 read")
        plain_size = os.path.getsize(plain_path)
        lz4_size = os.path.getsize(lz4_path)
        print(f"host plane: LZ4 over {head.num_rows} rows: {lz4_size} of "
              f"{plain_size} bytes (ratio {plain_size / lz4_size:.3f}); "
              f"write {lz4_write_s:.3f} s, read onto the card "
              f"{lz4_read_s:.3f} s ({plain_size / lz4_read_s / 1e9:.3f} "
              f"GB/s of uncompressed data); equal to the table [{card}]",
              flush=True)
        del back, head

        # 5: Feather V2 and V1 on the orders batch
        v2_path = os.path.join(tmp, "orders.feather")
        t0 = time.perf_counter()
        feather.write_table(ob, v2_path)
        v2_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        v2 = feather.read_table(v2_path)
        torch.cuda.synchronize()
        v2_read_s = time.perf_counter() - t0
        _same_batches(v2.batches, [ob], "Feather V2")
        v1_path = os.path.join(tmp, "orders.v1.feather")
        t0 = time.perf_counter()
        with open(v1_path, "wb") as f:
            feather1.write_feather_v1(ob, f)
        v1_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(v1_path, "rb") as f:
            v1 = feather1.read_feather_v1(f.read(), device=dev)
        torch.cuda.synchronize()
        v1_read_s = time.perf_counter() - t0
        _same_batches([v1], [ob], "Feather V1")
        print(f"host plane: Feather V2 (LZ4) of the {ob.num_rows} orders: "
              f"{os.path.getsize(v2_path)} bytes, write {v2_write_s:.3f} "
              f"s, read {v2_read_s:.3f} s; Feather V1: "
              f"{os.path.getsize(v1_path)} bytes, write {v1_write_s:.3f} s, "
              f"read {v1_read_s:.3f} s; both equal to the batch [{card}]",
              flush=True)
        del v2, v1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 6: the profiler over the read columns
    price = ft.column("l_extendedprice").combine_chunks()
    disc = ft.column("l_discount").combine_chunks()
    days = ft.column("l_shipdate_days").combine_chunks()
    batch = pt.RecordBatch((price, disc), ("l_extendedprice", "l_discount"))
    mask = compute.less_equal(days, pt.scalar(10000))
    calls = (("filter", lambda: compute.filter(batch, mask)),
             ("add", lambda: compute.add(price, disc)),
             ("sum", lambda: compute.sum(price)))
    for _, run in calls:
        run()   # warm-up (unprofiled, uncounted)
    torch.cuda.synchronize()
    for kern in counted:
        kern.launches = 0
    with profiler.KernelProfiler(dev) as prof:
        for _ in range(HOST_PLANE_PROFILE_REPEATS):
            outs = {name: run() for name, run in calls}
    torch.cuda.synchronize()
    for kern in counted:
        launches[kern.__name__] += kern.launches
    want_bytes = {"filter": (_datum_bytes(batch) + _datum_bytes(mask),
                             _datum_bytes(outs["filter"])),
                  "add": (_datum_bytes(price) + _datum_bytes(disc),
                          _datum_bytes(outs["add"])),
                  "sum": (_datum_bytes(price), _datum_bytes(outs["sum"]))}
    names = [name for name, _ in calls]
    if [r.name for r in prof.records] != \
            names * HOST_PLANE_PROFILE_REPEATS:
        raise AssertionError(f"profiler recorded {prof.records}")
    hbm = profiler.hbm_peak_bytes_per_sec(dev)
    for r in prof.records:
        if (r.bytes_in, r.bytes_out) != want_bytes[r.name]:
            raise AssertionError(f"profiler: {r.name} counted "
                                 f"{(r.bytes_in, r.bytes_out)} bytes, the "
                                 f"tensors hold {want_bytes[r.name]}")
    for name in names:
        recs = [r for r in prof.records if r.name == name]
        walls = [r.wall_s for r in recs]
        wall = statistics.median(walls)
        moved = recs[0].bytes_moved
        print(f"host plane profile: {name} over {price.length} rows "
              f"{wall * 1e3:.3f} ms (median of "
              f"{HOST_PLANE_PROFILE_REPEATS} after a warm-up, "
              f"{min(walls) * 1e3:.3f}-{max(walls) * 1e3:.3f} ms, each "
              f"timed on the host between two synchronizes), "
              f"{moved / 1e6:.3f} MB, {100 * moved / wall / hbm:.1f}% of "
              f"{hbm:.3g} B/s [{card}]", flush=True)
    print(prof.report(), flush=True)
    del price, disc, days, batch, mask, outs, ft

    # 7-8: the runtime's reports; no pyarrow, flatbuffers or zstandard
    print(f"host plane: {runtime.build_info()}; "
          f"{runtime.runtime_info()}", flush=True)
    alloc, torch_alloc = pt.total_allocated_bytes(), \
        torch.cuda.memory_allocated()
    stats = runtime.device_memory_stats()
    print(f"host plane: total_allocated_bytes {alloc}, "
          f"torch.cuda.memory_allocated {torch_alloc}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(device_memory_stats peak {stats.get('peak_bytes_in_use')}) "
          f"[{card}]", flush=True)
    if alloc != torch_alloc:
        raise AssertionError("total_allocated_bytes differs from "
                             "torch.cuda.memory_allocated")
    if not native.native_available():
        raise AssertionError("the native library was unloaded")
    loaded = [m for m in ("pyarrow", "flatbuffers", "zstandard")
              if m in sys.modules]
    if loaded:
        raise AssertionError(f"the host plane imported {loaded}")
    return launches


def _orders_ndjson(ob) -> bytes:
    """The orders batch as newline-delimited JSON, one object a row,
    formatted column by column with numpy (the CSV writer's byte-matrix
    helpers)."""
    from arrow1_tpu_torch.io.csv import _int_field, _join, _lit, _pool_field

    pool = [json.dumps(v).encode() for v in
            ob["o_orderpriority"].dictionary.values.tolist()]
    host = {n: ob[n].data.cpu().numpy() for n in ob.names}
    out = []
    for lo in range(0, ob.num_rows, 1 << 20):
        k = {n: a[lo:lo + (1 << 20)] for n, a in host.items()}
        n = len(k["o_orderkey"])
        mat, mask = _join(_lit(b'{"o_orderkey": ', n),
                          _int_field(k["o_orderkey"]),
                          _lit(b', "o_custkey": ', n),
                          _int_field(k["o_custkey"]),
                          _lit(b', "o_orderpriority": ', n),
                          _pool_field(pool, k["o_orderpriority"]
                                      .astype(np.int64)),
                          _lit(b"}\n", n))
        out.append(mat[mask].tobytes())
    return b"".join(out)


def _secs(fn):
    """(result, seconds) of one call, the card synchronised around it."""
    out, ms = _wall_ms(fn)
    return out, ms / 1e3


def _slices_equal(batch, batches, label):
    """One read batch against the table's batches, slice by slice."""
    lo = 0
    for i, b in enumerate(batches):
        _same_batches([batch.slice(lo, b.num_rows)], [b], f"{label} {i}")
        lo += b.num_rows
    if lo != batch.num_rows:
        raise AssertionError(f"{label}: {batch.num_rows} rows, not {lo}")


def phase_file_formats(pt, dev, counted, lt, ob, want):
    """Phase 22: the SF10 line items and orders through CSV, JSON, Parquet,
    ORC and the C++ IPC writer and back onto the card into Q1, Q1 by year
    and Q3. Returns the launch counts of its counted runs."""
    from arrow1_tpu_torch import models
    from arrow1_tpu_torch.io import csv as pcsv
    from arrow1_tpu_torch.io import ipc as pio
    from arrow1_tpu_torch.io import ipc_cpp, orc as porc
    from arrow1_tpu_torch.io import json as pjson
    from arrow1_tpu_torch.io import parquet as ppq
    from arrow1_tpu_torch.table import concat_batches

    card = _card_line()
    launches = {kern.__name__: 0 for kern in counted}
    t32 = _date32_lineitem(pt, lt)
    rows = t32.batches[0].num_rows   # 2^20 (phase 12's batches)
    year_aggs = [("l_quantity", "sum"), ("l_quantity", "count")]

    def q1(t):
        return models.q1_pricing_summary(t)

    def q1_year(t):
        return _q1_date32(pt, t, "l_year", year_aggs)

    def counted_run(label, run):
        """One warm-up, then one run with the counts set to 0; its result,
        launches and the median wall of three more."""
        run()
        torch.cuda.synchronize()
        for kern in counted:
            kern.launches = 0
        out = run()
        torch.cuda.synchronize()
        got = {kern.__name__: kern.launches for kern in counted}
        for kname, count in got.items():
            launches[kname] += count
        walls = [_wall_ms(run)[1] for _ in range(3)]
        return out, got, statistics.median(walls)

    def check_q1s(label, table):
        """Q1 and Q1 by year over ``table`` bit-equal to the same queries
        over the in-memory table and equal to the numpy oracles."""
        for qname, run, oracle, kern in (
                ("Q1", q1, "q1", "compact"),
                ("Q1 by year", q1_year, "q1_years", "segment_sums")):
            out, got, wall = counted_run(label, lambda: run(table))
            if got[kern] <= 0:
                raise AssertionError(f"{label} {qname} launched no "
                                     f"{kern}")
            mem = run(t32)
            for name in mem.names:
                _same_column_bits(out[name], mem[name],
                                  f"{label} {qname} {name}")
            _check_sf10(out, want[oracle], f"{label} {qname}")
            print(f"file formats: {label} {qname} over "
                  f"{table.num_rows} rows: bit-equal to {qname} over the "
                  f"in-memory table and equal to the numpy oracle; wall "
                  f"{wall:.3f} ms (median of 3); one run: K2 "
                  f"{got['compact']}, K3 {got['segment_sums']} [{card}]",
                  flush=True)

    def leg_line(label, rows, size, write_s, read_s, extra=""):
        print(f"file formats: {label}: {rows} rows, {size} bytes; write "
              f"{write_s:.3f} s ({size / write_s / 1e9:.3f} GB/s, page "
              f"cache, not flushed); read onto the card {read_s:.3f} s "
              f"({size / read_s / 1e9:.3f} GB/s, warm page cache){extra}; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]", flush=True)

    table_bytes = sum(_datum_bytes(b) for b in t32.batches)
    tmp = tempfile.mkdtemp(prefix="a1t-file-formats-")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"file formats: {tmp} has {free} bytes free; the line items "
              f"hold {table_bytes} bytes on the card", flush=True)
        if free < 2 * table_bytes:
            raise AssertionError(f"file formats: {free} bytes free in "
                                 f"{tmp}, fewer than twice the table's "
                                 f"{table_bytes}")

        # CSV: write, read onto the card, then stream into Q1
        path = os.path.join(tmp, "lineitem.csv")
        torch.cuda.reset_peak_memory_stats()
        _, write_s = _secs(lambda: pcsv.write_csv(t32, path))
        size = os.path.getsize(path)
        got, read_s = _secs(lambda: pcsv.read_csv(path))
        if got.batches[0]["l_quantity"].device.type != \
                torch.device(dev).type:
            raise AssertionError("read_csv did not place its batch on "
                                 "the card")
        _slices_equal(got.batches[0], t32.batches, "CSV read")
        del got
        streamed, stream_s = _secs(lambda: pt.Table(list(
            pcsv.open_csv_stream(path, batch_rows=rows))))
        _same_batches(streamed.batches, t32.batches, "CSV stream")
        leg_line("CSV", t32.num_rows, size, write_s, read_s,
                 f"; open_csv_stream in 2^20-row batches {stream_s:.3f} s; "
                 f"both equal to the table, floats bit for bit")
        check_q1s("CSV", streamed)
        del streamed
        os.remove(path)

        # JSON: SF10's orders as NDJSON made with numpy, into Q3
        path = os.path.join(tmp, "orders.json")
        torch.cuda.reset_peak_memory_stats()

        def write_json():
            with open(path, "wb") as f:
                f.write(_orders_ndjson(ob))

        _, write_s = _secs(write_json)
        size = os.path.getsize(path)
        got, read_s = _secs(lambda: pjson.read_json(path))
        jb = got.batches[0]
        _same_batches([jb], [ob], "JSON read")
        out, got_l, wall = counted_run(
            "JSON", lambda: models.q3_shipping_priority(lt, jb))
        _check_sf10(out, want["q3"], "JSON Q3")
        if got_l["compact"] <= 0:
            raise AssertionError("JSON Q3 launched no K2")
        leg_line("JSON (orders)", jb.num_rows, size, write_s, read_s,
                 "; equal to the orders batch")
        print(f"file formats: JSON Q3 through query() over the read orders:"
              f" equal to the numpy oracle; wall {wall:.3f} ms (median of "
              f"3); one run: K2 {got_l['compact']}, K3 "
              f"{got_l['segment_sums']} [{card}]", flush=True)
        del got, jb, out
        os.remove(path)

        # Parquet: 2^20-row row groups, snappy
        path = os.path.join(tmp, "lineitem.parquet")
        torch.cuda.reset_peak_memory_stats()
        _, write_s = _secs(lambda: ppq.write_parquet(
            t32, path, row_group_size=rows))
        size = os.path.getsize(path)
        got, read_s = _secs(lambda: ppq.read_parquet(path))
        _slices_equal(got.batches[0], t32.batches, "Parquet read")
        del got
        it, iter_s = _secs(lambda: pt.Table(list(
            ppq.iter_parquet_batches(path))))
        _same_batches(it.batches, t32.batches, "Parquet row groups")
        leg_line("Parquet", t32.num_rows, size, write_s, read_s,
                 f"; iter_parquet_batches {iter_s:.3f} s, "
                 f"{len(it.batches)} row groups; both equal to the table")
        check_q1s("Parquet", it)
        del it
        cols = ["l_returnflag", "l_extendedprice"]
        got, proj_s = _secs(lambda: ppq.read_parquet(path, columns=cols))
        _slices_equal(got.batches[0], [b.select(cols) for b in t32.batches],
                      "Parquet projection")
        del got
        filt = [("l_shipdate_days", "<=", 10000)]
        k2 = next(k for k in counted if k.__name__ == "compact")
        for kern in counted:
            kern.launches = 0
        got, filt_s = _secs(lambda: ppq.read_parquet(path, filters=filt))
        filt_k2 = k2.launches
        launches["compact"] += filt_k2
        mem = concat_batches([pt.call_function("filter", [
            b, pt.call_function("less_equal", [b["l_shipdate_days"],
                                               pt.scalar(10000)])])
            for b in t32.batches])
        _same_batches(got.batches, [mem], "Parquet filters")
        print(f"file formats: Parquet columns={cols} read "
              f"{proj_s:.3f} s; filters={filt} read {filt_s:.3f} s, "
              f"{got.num_rows} rows, K2 {filt_k2}; both equal to the same "
              f"projection and filter of the in-memory table [{card}]",
              flush=True)
        del got, mem
        os.remove(path)

        # ORC: a stripe a batch
        path = os.path.join(tmp, "lineitem.orc")
        torch.cuda.reset_peak_memory_stats()
        _, write_s = _secs(lambda: porc.write_orc(t32, path))
        size = os.path.getsize(path)
        got, read_s = _secs(lambda: porc.read_orc(path))
        _same_batches(got.batches, t32.batches, "ORC read")
        leg_line("ORC", t32.num_rows, size, write_s, read_s,
                 f", {len(got.batches)} stripes; equal to the table")
        check_q1s("ORC", got)
        del got
        os.remove(path)

        # the C++ IPC writer: the orders' int64 columns
        path = os.path.join(tmp, "orders.arrow")
        names = ["o_orderkey", "o_custkey"]
        host = [ob[n].data.cpu().numpy() for n in names]
        _, write_s = _secs(lambda: ipc_cpp.write_ipc_cpp(path, names, host))
        size = os.path.getsize(path)
        got, read_s = _secs(lambda: pio.read_ipc(path))
        _same_batches(got.batches, [ob.select(names)], "C++ IPC file")
        leg_line("C++ IPC writer (orders' int64 columns)", ob.num_rows,
                 size, write_s, read_s, "; read_ipc equal to the batch")
        del got
        os.remove(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = [m for m in ("pyarrow", "zstandard", "cryptography")
              if m in sys.modules]
    if loaded:
        raise AssertionError(f"the file formats imported {loaded}")
    return launches


# ---- phase 23: datasets, file systems and bridges ----------------------

S3_KEYS = ("AKIDSMOKE", "smoke-secret", "us-east-1")
BRIDGE_ROWS = 10_000_000             # the builders' and the tensor's rows
TENSOR_RTOL = 1e-12                  # matvec on the card against the CPU's
PLASMA_BYTES = 1 << 30               # the store's capacity


def _mock_s3():
    """An in-process S3 (ThreadingHTTPServer on 127.0.0.1, any free port)
    with enough of the REST dialect for the native client: HEAD, ranged
    GET, PUT, DELETE, ListObjectsV2 with a delimiter and multipart upload;
    every signed request's SigV4 signature is checked again here and a
    mismatch is recorded in ``bad``. Returns (server, store, bad)."""
    import hashlib
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from arrow1_tpu_torch.fs_s3 import sigv4_sign

    store, uploads, bad = {}, {}, []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _split(self):
            path, _, qs = self.path.partition("?")
            bucket, _, key = urllib.parse.unquote(path).lstrip("/") \
                .partition("/")
            return bucket, key, dict(urllib.parse.parse_qsl(
                qs, keep_blank_values=True))

        def _signed(self, body: bytes) -> bool:
            auth = self.headers.get("Authorization", "")
            path, _, qs = self.path.partition("?")
            want = sigv4_sign(
                self.command, self.headers["Host"], path,
                urllib.parse.parse_qsl(qs, keep_blank_values=True),
                {k.lower(): v for k, v in self.headers.items()
                 if k.lower() == "range"},
                self.headers.get("x-amz-content-sha256",
                                 hashlib.sha256(body).hexdigest()),
                S3_KEYS[0], S3_KEYS[1], S3_KEYS[2], "s3",
                self.headers.get("x-amz-date", ""))["Authorization"]
            if auth != want:
                bad.append((self.command, self.path))
            return auth == want

        def _reply(self, status, body=b"", headers=(), length=None):
            self.send_response(status)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(
                len(body) if length is None else length))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0) or 0)
            return self.rfile.read(n) if n else b""

        def do_HEAD(self):
            bucket, key, _ = self._split()
            data = store.get((bucket, key))
            self._reply(404) if data is None else \
                self._reply(200, length=len(data))

        def do_GET(self):
            if not self._signed(b""):
                return self._reply(403)
            bucket, key, q = self._split()
            if "list-type" in q:
                prefix, delim = q.get("prefix", ""), q.get("delimiter", "")
                files, dirs = [], []
                for b, k in sorted(store):
                    if b != bucket or not k.startswith(prefix):
                        continue
                    rest = k[len(prefix):]
                    if delim and delim in rest:
                        d = prefix + rest.split(delim)[0] + delim
                        if d not in dirs:
                            dirs.append(d)
                    else:
                        files.append(k)
                xml = ["<ListBucketResult><IsTruncated>false</IsTruncated>"]
                xml += [f"<Contents><Key>{k}</Key><Size>"
                        f"{len(store[(bucket, k)])}</Size></Contents>"
                        for k in files]
                xml += [f"<CommonPrefixes><Prefix>{d}</Prefix>"
                        f"</CommonPrefixes>" for d in dirs]
                return self._reply(200, ("".join(xml) +
                                         "</ListBucketResult>").encode())
            data = store.get((bucket, key))
            if data is None:
                return self._reply(404)
            rng = self.headers.get("Range")
            if not rng:
                return self._reply(200, data)
            lo, _, hi = rng.split("=")[1].partition("-")
            hi = min(int(hi), len(data) - 1) if hi else len(data) - 1
            self._reply(206, data[int(lo):hi + 1])

        def do_PUT(self):
            body = self._body()
            if not self._signed(body):
                return self._reply(403)
            bucket, key, q = self._split()
            if "partNumber" in q:
                uploads[q["uploadId"]][int(q["partNumber"])] = body
            else:
                store[(bucket, key)] = body
            self._reply(200, headers=[("ETag", '"e"')])

        def do_POST(self):
            body = self._body()
            if not self._signed(body):
                return self._reply(403)
            bucket, key, q = self._split()
            if "uploads" in q:
                uid = f"up{len(uploads)}"
                uploads[uid] = {}
                return self._reply(200, (
                    f"<InitiateMultipartUploadResult><UploadId>{uid}"
                    f"</UploadId></InitiateMultipartUploadResult>").encode())
            parts = uploads.pop(q["uploadId"])
            store[(bucket, key)] = b"".join(parts[i] for i in sorted(parts))
            self._reply(200, b"<CompleteMultipartUploadResult/>")

        def do_DELETE(self):
            if not self._signed(b""):
                return self._reply(403)
            bucket, key, _ = self._split()
            store.pop((bucket, key), None)
            self._reply(204)

    return ThreadingHTTPServer(("127.0.0.1", 0), Handler), store, bad


def _mock_webhdfs():
    """An in-process WebHDFS namenode and datanode (WebHDFS v1 REST:
    GETFILESTATUS, LISTSTATUS with directories, OPEN with offset/length,
    CREATE through a 307 to the datanode, MKDIRS, DELETE). Returns
    (server, files)."""
    import json as _json
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    files = {}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _parse(self):
            u = urllib.parse.urlsplit(self.path)
            return (urllib.parse.unquote(u.path[len("/webhdfs/v1"):]),
                    dict(urllib.parse.parse_qsl(u.query)))

        def _send(self, status, body=b""):
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, status=200):
            self._send(status, _json.dumps(obj).encode())

        def do_GET(self):
            path, q = self._parse()
            base = path.rstrip("/")
            under = [k for k in files if k.startswith(base + "/")]
            if q["op"] == "GETFILESTATUS":
                if path in files:
                    return self._json({"FileStatus": {
                        "type": "FILE", "length": len(files[path])}})
                if under:
                    return self._json({"FileStatus": {
                        "type": "DIRECTORY", "length": 0}})
                return self._json({"RemoteException": {
                    "message": f"not found: {path}"}}, 404)
            if q["op"] == "LISTSTATUS":
                kids = {}
                for k in under:
                    head, sep, _ = k[len(base) + 1:].partition("/")
                    kids[head] = ("DIRECTORY", 0) if sep else \
                        ("FILE", len(files[k]))
                return self._json({"FileStatuses": {"FileStatus": [
                    {"pathSuffix": n, "type": t, "length": ln}
                    for n, (t, ln) in sorted(kids.items())]}})
            if q["op"] == "OPEN" and path in files:
                data = files[path]
                off = int(q.get("offset", 0))
                return self._send(200, data[off:off + int(
                    q.get("length", len(data) - off))])
            self._json({"RemoteException": {"message": path}}, 404)

        def do_PUT(self):
            path, q = self._parse()
            if q["op"] == "CREATE" and "datanode" not in q:
                self.send_response(307)
                self.send_header("Location", f"http://127.0.0.1:"
                                 f"{self.server.server_port}{self.path}"
                                 f"&datanode=1")
                self.send_header("Content-Length", "0")
                return self.end_headers()
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0) or 0))
            if q["op"] == "CREATE":
                files[path] = body
            self._json({"boolean": True}, 201 if q["op"] == "CREATE"
                       else 200)

        def do_DELETE(self):
            path, _ = self._parse()
            for k in [k for k in files if k == path
                      or k.startswith(path.rstrip("/") + "/")]:
                del files[k]
            self._json({"boolean": True})

    return ThreadingHTTPServer(("127.0.0.1", 0), Handler), files


def _serving(server):
    """Serve ``server`` on a daemon thread; returns the thread."""
    import threading

    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _by_year(pt, src, years):
    """The source's rows year by year (ascending), in source order within
    a year, as one batch: the order a Hive dataset of it scans in."""
    from arrow1_tpu_torch.table import concat_batches

    years_rows = []
    for y in years:   # a year at a time: the filter's outputs are freed
        parts = [pt.call_function("filter", [b, pt.call_function(
            "equal", [b["l_shipyear"], pt.scalar(int(y))])])
            for b in src.batches]
        years_rows.append(concat_batches([p for p in parts if p.num_rows]))
        del parts
    return concat_batches(years_rows)


def _q6_year_oracle(src, year):
    """Numpy Q6 of one ship year: revenue by return flag, from host copies
    of each batch (flag codes decoded through each batch's own pool)."""
    sums = {}
    for b in src.batches:
        h = {n: b[n].data.cpu().numpy() for n in (
            "l_discount", "l_quantity", "l_extendedprice", "l_returnflag",
            "l_shipyear")}
        keep = (h["l_discount"] >= 0.02) & (h["l_discount"] <= 0.09) & \
            (h["l_quantity"] < 24) & (h["l_shipyear"] == year)
        pool = b["l_returnflag"].dictionary.values
        part = np.bincount(h["l_returnflag"][keep],
                           weights=h["l_extendedprice"][keep],
                           minlength=len(pool))
        for flag, s in zip(pool.tolist(), part.tolist()):
            sums[flag] = sums.get(flag, 0.0) + s
    return sums


def _q6_year(pt, source, year):
    return (pt.query(source)
            .filter((pt.field("l_discount") >= 0.02)
                    & (pt.field("l_discount") <= 0.09)
                    & (pt.field("l_quantity") < 24)
                    & (pt.field("l_shipyear") == year))
            .group_by(["l_returnflag"], [("l_extendedprice", "sum")])
            .to_batch())


def _plasma_child(name: str, oid: bytes, echo: bytes, dev) -> str:
    """The child's program: open the store, read the table onto ``dev``
    and store it again under ``echo``."""
    dev = torch.device(dev)
    return ("import sys; sys.path.insert(0, '.')\n"
            "from arrow1_tpu_torch import plasma\n"
            f"st = plasma.connect({name!r}, create=False)\n"
            f"t = st.get(plasma.ObjectID({oid!r}), device={str(dev)!r})\n"
            f"assert t.batches[0].columns[0].device.type == {dev.type!r}\n"
            f"st.put(t, plasma.ObjectID({echo!r}))\n"
            "st.close()\n")


def phase_datasets(pt, dev, counted, lt, ob, want):
    """Phase 23: the SF10 line items as a year-partitioned Parquet dataset,
    read back onto the card whole, into Q1 and Q1 by year through
    query(dataset) and into a pruned Q6; the dataset's scanner, head and
    ParquetDataset; one partition through mock S3 and WebHDFS servers;
    then the bridges: the C stream interface, the builders, validate,
    tensor, gandiva and the plasma store. Returns the launch counts of its
    counted runs."""
    from arrow1_tpu_torch import (builders, cdata, dataset as ds, gandiva,
                                  models, plasma, tensor, validate)
    from arrow1_tpu_torch import dtypes as dt
    from arrow1_tpu_torch import parquet as ppq
    from arrow1_tpu_torch.fs import LocalFileSystem, copy_files
    from arrow1_tpu_torch.fs_s3 import NativeS3FileSystem
    from arrow1_tpu_torch.table import concat_batches

    card = _card_line()
    launches = {kern.__name__: 0 for kern in counted}
    t32 = _date32_lineitem(pt, lt)
    src = pt.Table([b.set_column("l_shipyear", pt.call_function(
        "year", [b["l_shipdate"]])) for b in t32.batches])
    days = np.concatenate([b["l_shipdate_days"].data.cpu().numpy()
                           for b in lt.batches])
    years = np.unique(days.astype("datetime64[D]").astype("datetime64[Y]")
                      .astype(np.int64) + 1970)
    del days
    n_rows = src.num_rows

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    def counted_run(run):
        """One run with the counts set to 0: its result, launches, wall."""
        torch.cuda.synchronize()
        for kern in counted:
            kern.launches = 0
        out, ms = _wall_ms(run)
        got = {kern.__name__: kern.launches for kern in counted}
        for kname, count in got.items():
            launches[kname] += count
        return out, got, ms

    tmp = tempfile.mkdtemp(prefix="a1t-datasets-")
    root = os.path.join(tmp, "lineitem")
    try:
        table_bytes = sum(_datum_bytes(b) for b in src.batches)
        free = shutil.disk_usage(tmp).free
        print(f"datasets: {tmp} has {free} bytes free; the line items hold "
              f"{table_bytes} bytes on the card", flush=True)
        if free < 2 * table_bytes:
            raise AssertionError(f"datasets: {free} bytes free, fewer than "
                                 f"twice the table's {table_bytes}")

        # write the dataset, find it, count it, read it back whole
        torch.cuda.reset_peak_memory_stats()
        _, write_s = _secs(lambda: ds.write_dataset(
            src, root, partitioning_keys=["l_shipyear"], format="parquet"))
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        D = ds.dataset(root, partitioning="hive")
        if len(D.fragments) != len(years):
            raise AssertionError(f"datasets: {len(D.fragments)} fragments "
                                 f"for {len(years)} ship years")
        count, count_s = _secs(D.count_rows)
        if count != n_rows:
            raise AssertionError(f"datasets: count_rows {count}, not "
                                 f"{n_rows}")
        got, read_s = _secs(D.to_table)
        if got.batches[0]["l_orderkey"].device.type != \
                torch.device(dev).type:
            raise AssertionError("datasets: to_table left the card")
        for b in got.batches:
            validate.validate_batch(b, full=True)
        want_rows = _by_year(pt, src, years)
        whole = concat_batches(got.batches)
        _same_batches([whole], [want_rows], "dataset to_table")
        print(f"datasets: write_dataset of {n_rows} rows by l_shipyear: "
              f"{len(D.fragments)} Parquet files (years {years[0]}-"
              f"{years[-1]}), {size} bytes in {write_s:.3f} s "
              f"({size / write_s / 1e9:.3f} GB/s, page cache, not flushed);"
              f" count_rows {count_s:.3f} s; to_table onto the card "
              f"{read_s:.3f} s ({size / read_s / 1e9:.3f} GB/s, warm page "
              f"cache), {len(got.batches)} batches, each valid "
              f"(validate_batch full), equal bit for bit to the source "
              f"year by year; peak device memory {peak_gib():.2f} GiB "
              f"[{card}]", flush=True)
        del got, whole

        # query(dataset): Q1, Q1 by year, and Q6 pruned to one year
        torch.cuda.reset_peak_memory_stats()
        year_aggs = [("l_quantity", "sum"), ("l_quantity", "count")]
        for qname, run, oracle, kern in (
                ("Q1", lambda: models.q1_pricing_summary(D), "q1",
                 "compact"),
                ("Q1 by year", lambda: _q1_date32(pt, D, "l_year",
                                                  year_aggs), "q1_years",
                 "segment_sums")):
            out, got_l, ms = counted_run(run)
            _check_sf10(out, want[oracle], f"dataset {qname}")
            if got_l[kern] <= 0:
                raise AssertionError(f"dataset {qname} launched no {kern}")
            print(f"datasets: {qname} through query(dataset): equal to the "
                  f"numpy oracle; wall {ms:.3f} ms (the scan included); K2 "
                  f"{got_l['compact']}, K3 {got_l['segment_sums']}; peak "
                  f"device memory {peak_gib():.2f} GiB [{card}]",
                  flush=True)
        q6_year = 1994 if 1994 in years else int(years[len(years) // 2])
        pred = pt.field("l_shipyear") == q6_year
        kept = D.get_fragments(pred)
        decoded = []
        real_scan = ds.Fragment.scan_batches

        def counting_scan(frag, *args, **kwargs):
            decoded.append(frag.path)
            return real_scan(frag, *args, **kwargs)

        ds.Fragment.scan_batches = counting_scan
        try:
            out, got_l, ms = counted_run(lambda: _q6_year(pt, D, q6_year))
        finally:
            ds.Fragment.scan_batches = real_scan
        if len(kept) != 1 or len(decoded) != 1:
            raise AssertionError(f"dataset Q6: {len(kept)} fragments kept, "
                                 f"{len(decoded)} decoded")
        oracle = _q6_year_oracle(src, q6_year)
        flags = out["l_returnflag"].to_numpy().tolist()
        sums = out["l_extendedprice_sum"].to_numpy()
        if sorted(flags) != sorted(oracle) or not np.allclose(
                sums, [oracle[f] for f in flags], rtol=SF10_RTOL, atol=0):
            raise AssertionError(f"dataset Q6: {flags} {sums} against "
                                 f"{oracle}")
        print(f"datasets: Q6 with l_shipyear == {q6_year}: pruning kept 1 "
              f"fragment of {len(D.fragments)} and 1 file was decoded; "
              f"equal to the numpy oracle; wall {ms:.3f} ms; K2 "
              f"{got_l['compact']} [{card}]", flush=True)

        # the scanner's projection and filter, head, ParquetDataset
        rev = pt.field("l_extendedprice") * pt.field("l_discount")
        cheap = pt.field("l_quantity") < 10
        sc, scan_s = _secs(lambda: ds.ScannerBuilder(D).filter(cheap)
                           .project([rev, pt.field("l_shipyear")],
                                    ["rev", "l_shipyear"]).finish()
                           .to_table())
        mem = (pt.query(want_rows).filter(cheap)
               .project([rev, pt.field("l_shipyear")],
                        ["rev", "l_shipyear"]).to_batch())
        _same_batches([concat_batches(sc.batches)], [mem],
                      "dataset projection")
        head = D.head(1000)
        _same_batches([concat_batches(head.batches)],
                      [want_rows.slice(0, 1000)], "dataset head")
        pq_ds = ppq.ParquetDataset(root, partitioning="hive")
        keys, pq_s = _secs(lambda: pq_ds.to_table(
            columns=["l_orderkey", "l_shipyear"]))
        _same_batches([concat_batches(keys.batches)],
                      [want_rows.select(["l_orderkey", "l_shipyear"])],
                      "ParquetDataset")
        print(f"datasets: ScannerBuilder filter + projection {scan_s:.3f} s"
              f" ({sc.num_rows} rows), head(1000) and ParquetDataset "
              f"columns=[l_orderkey, l_shipyear] {pq_s:.3f} s: each equal "
              f"to the same operations on the in-memory table [{card}]",
              flush=True)
        del sc, mem, head, keys

        # one partition through the S3 and WebHDFS clients and back
        first = 1992 if 1992 in years else int(years[0])
        part_dir = os.path.join(root, f"l_shipyear={first}")
        part_bytes = sum(os.path.getsize(os.path.join(part_dir, f))
                         for f in os.listdir(part_dir))
        local = concat_batches(D.to_table(
            filter=pt.field("l_shipyear") == first).batches)
        s3_server, _, bad = _mock_s3()
        hd_server, _ = _mock_webhdfs()
        threads = [_serving(s3_server), _serving(hd_server)]
        try:
            s3fs = NativeS3FileSystem(
                access_key=S3_KEYS[0], secret_key=S3_KEYS[1],
                region=S3_KEYS[2], scheme="http", request_timeout=60,
                endpoint_override=f"127.0.0.1:{s3_server.server_port}")
            _, s3_put = _secs(lambda: copy_files(
                part_dir, f"bkt/lineitem/l_shipyear={first}",
                LocalFileSystem(), s3fs))
            uri = (f"s3://{S3_KEYS[0]}:{S3_KEYS[1]}@bkt/lineitem?"
                   f"endpoint_override=127.0.0.1:{s3_server.server_port}"
                   f"&scheme=http&region={S3_KEYS[2]}")
            s3_got, s3_read = _secs(lambda: ds.dataset(
                uri, partitioning="hive").to_table())
            _same_batches([concat_batches(s3_got.batches)], [local],
                          "S3 dataset")
            if bad:
                raise AssertionError(f"S3: signatures failed: {bad[:3]}")
            hd_uri = (f"webhdfs://smoke@127.0.0.1:{hd_server.server_port}"
                      f"/warehouse/lineitem")
            from arrow1_tpu_torch.fs import filesystem_from_uri

            hdfs, _ = filesystem_from_uri(hd_uri)
            _, hd_put = _secs(lambda: copy_files(
                part_dir, f"/warehouse/lineitem/l_shipyear={first}",
                LocalFileSystem(), hdfs))
            hd_got, hd_read = _secs(lambda: ds.dataset(
                hd_uri, partitioning="hive").to_table())
            _same_batches([concat_batches(hd_got.batches)], [local],
                          "WebHDFS dataset")
        finally:
            for server, t in zip((s3_server, hd_server), threads):
                _stop(server, t)
        print(f"datasets: the {first} partition ({part_bytes} bytes, "
              f"{local.num_rows} rows) through mock servers on 127.0.0.1: "
              f"S3 (SigV4 checked on every request) upload {s3_put:.3f} s "
              f"({part_bytes / s3_put / 1e9:.3f} GB/s), dataset read onto "
              f"the card {s3_read:.3f} s ({part_bytes / s3_read / 1e9:.3f} "
              f"GB/s); WebHDFS upload {hd_put:.3f} s "
              f"({part_bytes / hd_put / 1e9:.3f} GB/s), dataset read "
              f"{hd_read:.3f} s ({part_bytes / hd_read / 1e9:.3f} GB/s); "
              f"each equal to the local read of that fragment [{card}]",
              flush=True)
        del s3_got, hd_got, local

        # bridges: the C stream interface over the orders
        torch.cuda.reset_peak_memory_stats()
        back, c_s = _secs(lambda: cdata.import_batch(cdata.export_batch(ob)))
        _same_batches([back], [ob], "C stream")
        print(f"bridges: the {ob.num_rows} orders exported as an "
              f"arrow_array_stream capsule and imported onto the card in "
              f"{c_s:.3f} s, equal to the batch; peak device memory "
              f"{peak_gib():.2f} GiB [{card}]", flush=True)
        del back

        # builders: 10M int64, float64 and string values against numpy
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(23)
        ints = rng.integers(-(1 << 62), 1 << 62, BRIDGE_ROWS)
        floats = rng.standard_normal(BRIDGE_ROWS)
        pool = np.array([f"Customer#{i:09d}" for i in range(150_000)],
                        object)
        strs = pool[rng.integers(0, len(pool), BRIDGE_ROWS)]
        t0 = time.perf_counter()
        ci = builders.Int64Builder().append_values(ints).finish()
        cf = builders.Float64Builder().append_values(floats).finish()
        cs = builders.StringBuilder().append_values(strs).finish()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if not (np.array_equal(ci.data.cpu().numpy(), ints) and
                np.array_equal(cf.data.cpu().numpy().view(np.int64),
                               floats.view(np.int64)) and
                np.array_equal(cs.dictionary.values[
                    cs.data.cpu().numpy()], strs) and
                ci.device.type == cf.device.type == cs.device.type ==
                torch.device(dev).type):
            raise AssertionError("builders differ from numpy")
        print(f"bridges: builders of {BRIDGE_ROWS} int64, float64 and "
              f"string values finished onto the card in {build_s:.3f} s, "
              f"equal to numpy (floats bit for bit); peak device memory "
              f"{peak_gib():.2f} GiB [{card}]", flush=True)
        del ci, cf, cs, ints, floats, strs

        # tensor: three float64 columns of 10M rows, on the card and CPU
        torch.cuda.reset_peak_memory_stats()
        lead, got_rows = [], 0
        for b in src.batches:
            if got_rows >= BRIDGE_ROWS:
                break
            lead.append(b)
            got_rows += b.num_rows
        b0 = concat_batches(lead).slice(0, BRIDGE_ROWS)
        del lead
        dense = torch.stack([b0["l_extendedprice"].data,
                             b0["l_discount"].data,
                             b0["l_quantity"].data.to(torch.float64)], 1)
        del b0
        x = torch.tensor([1.0, -2.5, 0.125], dtype=torch.float64)

        def tensor_calls(t):
            coo = tensor.Tensor(t).to_coo()
            csr = coo.to_csr()
            return coo, csr, csr.to_dense().data, \
                csr.matvec(x.to(t.device))

        (coo, csr, back, y), t_s = _secs(lambda: tensor_calls(dense))
        coo_c, csr_c, back_c, y_c = tensor_calls(dense.cpu())
        if not (torch.equal(coo.coords.cpu(), coo_c.coords) and
                torch.equal(csr.indptr.cpu(), csr_c.indptr) and
                torch.equal(csr.indices.cpu(), csr_c.indices) and
                torch.equal(back, dense) and torch.equal(back_c,
                                                         dense.cpu())):
            raise AssertionError("tensor: COO/CSR/dense differ from the "
                                 "CPU's")
        rel = float(((y.cpu() - y_c).abs() / y_c.abs().clamp_min(1e-300))
                    .max())
        if rel > TENSOR_RTOL:
            raise AssertionError(f"tensor: matvec off by {rel}")
        print(f"bridges: tensor of {dense.shape[0]}x3 float64: to_coo "
              f"({coo.non_zero_length} nonzeros), to_csr, to_dense and "
              f"matvec on the card {t_s:.3f} s; COO, CSR and dense equal "
              f"to the CPU's, matvec within {rel:.3g} relative "
              f"(bound {TENSOR_RTOL}); peak device memory "
              f"{peak_gib():.2f} GiB [{card}]", flush=True)
        del dense, coo, csr, back, y, coo_c, csr_c, back_c, y_c

        # gandiva: Q6's predicate and revenue over one year's batches
        q6_pred = (pt.field("l_discount") >= 0.02) & \
            (pt.field("l_discount") <= 0.09) & (pt.field("l_quantity") < 24)
        year_batches = D.to_table(filter=pred).batches
        filt = gandiva.make_filter(year_batches[0], q6_pred)
        proj = gandiva.make_projector(year_batches[0], [(rev, "revenue")])
        t0 = time.perf_counter()
        outs = [proj.evaluate(b, filt.evaluate(b)) for b in year_batches]
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        mem = [pt.query(b).filter(q6_pred).project([rev], ["revenue"])
               .to_batch() for b in year_batches]
        _same_batches(outs, mem, "gandiva")
        print(f"bridges: gandiva Filter (Q6's predicate) and Projector "
              f"(revenue) over {len(year_batches)} batches of "
              f"{q6_year} in {g_s:.3f} s, equal to query()'s filter and "
              f"projection [{card}]", flush=True)
        del year_batches, outs, mem

        # plasma: the orders' int64 columns, here and in a child process
        name = f"/a1t-smoke-{os.getpid()}"
        ints_batch = ob.select(["o_orderkey", "o_custkey"])
        shm_free = shutil.disk_usage("/dev/shm").free
        if shm_free < 3 * _datum_bytes(ints_batch):
            raise AssertionError(f"plasma: /dev/shm has {shm_free} bytes "
                                 f"free, too few for two copies of "
                                 f"{_datum_bytes(ints_batch)}")
        store = plasma.PlasmaStore(name, capacity=PLASMA_BYTES,
                                   max_objects=8)
        try:
            oid, echo = plasma.ObjectID.of("orders"), \
                plasma.ObjectID.of("echo")
            _, put_s = _secs(lambda: store.put(ints_batch, oid))
            used = store.bytes_used
            mine, get_s = _secs(lambda: store.get(oid))
            _same_batches(mine.batches, [ints_batch], "plasma get")
            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, "-c", _plasma_child(
                    name, oid.binary, echo.binary, dev)],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=300)
            child_s = time.perf_counter() - t0
            if child.returncode:
                raise AssertionError(f"plasma child failed: "
                                     f"{child.stderr[-2000:]}")
            _same_batches(store.get(echo).batches, [ints_batch],
                          "plasma child")
        finally:
            store.destroy()
        print(f"bridges: plasma put of the orders' int64 columns "
              f"({used} bytes in the store) {put_s:.3f} s, get onto the "
              f"card {get_s:.3f} s; a child process read them onto its "
              f"card and stored them again in {child_s:.3f} s (its start "
              f"included); both copies equal to the batch [{card}]",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = [m for m in ("pyarrow", "jax", "grpc", "zstandard",
                          "cryptography") if m in sys.modules]
    if loaded:
        raise AssertionError(f"the datasets phase imported {loaded}")
    return launches


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
    peak = _peak()
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
    v1_err, v1_row = phase_segment_sum_count(segsum, segsum2, dev,
                                             peak)
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
    sf10_launches, sf10_lineitem, sf10_orders, sf10_want = phase_sf10(
        pt, dev, peak, all_kernels)
    print(f"SF10 query layer launches: {sf10_launches}", flush=True)
    for kname, count in sf10_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    phase_config3(dev)
    torch.cuda.empty_cache()
    tail_launches = phase_compute_tail(pt, dev, all_kernels)
    for kname, count in tail_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    string_launches = phase_strings(pt, dev, all_kernels)
    for kname, count in string_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    temporal_launches = phase_temporal(pt, dev, all_kernels, sf10_lineitem,
                                       sf10_want)
    print(f"temporal main path launches: {temporal_launches}", flush=True)
    for kname, count in temporal_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    decimal_launches = phase_decimal(pt, dev, all_kernels, sf10_lineitem)
    print(f"decimal main path launches: {decimal_launches}", flush=True)
    for kname, count in decimal_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    nested_launches = phase_nested(pt, dev, all_kernels, sf10_lineitem)
    print(f"nested main path launches: {nested_launches}", flush=True)
    for kname, count in nested_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    dist_launches = phase_distributed(pt, dev, all_kernels, sf10_lineitem,
                                      sf10_orders, sf10_want)
    print(f"distributed main path launches: {dist_launches}", flush=True)
    for kname, count in dist_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    host_launches = phase_host_plane(pt, dev, all_kernels, sf10_lineitem,
                                     sf10_orders, sf10_want)
    print(f"host plane main path launches: {host_launches}", flush=True)
    for kname, count in host_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    format_launches = phase_file_formats(pt, dev, all_kernels, sf10_lineitem,
                                         sf10_orders, sf10_want)
    print(f"file formats main path launches: {format_launches}", flush=True)
    for kname, count in format_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    torch.cuda.empty_cache()
    dataset_launches = phase_datasets(pt, dev, all_kernels, sf10_lineitem,
                                      sf10_orders, sf10_want)
    print(f"datasets main path launches: {dataset_launches}", flush=True)
    for kname, count in dataset_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    del sf10_lineitem, sf10_orders
    torch.cuda.empty_cache()
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
             source="arrow1_tpu_torch/csrc/probe_ops.cu",
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
