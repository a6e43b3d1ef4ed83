"""The port's runtime slice (types, cancel, thread_pool, memory, runtime,
utils/timing, profiler, io/streams, io/compression) against the JAX
package: every ``types`` predicate over every type both packages name
(where the two differ, pyarrow decides: ROADMAP Queue 3), and the twins of
the reference's cancel, thread-pool, memory-pool, stream, runtime and
profiler tests (tests/test_misc_components.py, test_thread_pool.py,
test_profiler.py) on ``device="cpu"``, the profiler's byte counts against
the reference's on the same calls."""

import io
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.types as pat
import pytest
import torch

import arrow1_tpu as a1t
import arrow1_tpu.compute as ac
import arrow1_tpu.types as ref_types
from arrow1_tpu import dtypes as ref_dt
from arrow1_tpu.profiler import KernelProfiler as RefProfiler

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.compute as pc
from arrow1_tpu_torch import dtypes as dt
from arrow1_tpu_torch import profiler, runtime
from arrow1_tpu_torch import types as port_types
from arrow1_tpu_torch.cancel import CancelledError, StopSource
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.io.compression import Codec, compress, decompress
from arrow1_tpu_torch.io.streams import (BufferedInputStream,
                                         BufferedOutputStream,
                                         BufferOutputStream, BufferReader,
                                         MemoryMappedFile, ReadRangeCache,
                                         input_stream, output_stream)
from arrow1_tpu_torch.memory import (LoggingMemoryPool, MemoryPool,
                                     ProxyMemoryPool)
from arrow1_tpu_torch.profiler import (KernelProfiler, KernelRecord,
                                       hbm_peak_bytes_per_sec)
from arrow1_tpu_torch.thread_pool import (Future, TaskGroup, ThreadPool,
                                          cpu_thread_pool, parallel_map)
from arrow1_tpu_torch.utils.timing import timed_device

TYPES = [pa.bool_(), pa.int8(), pa.int16(), pa.int32(), pa.int64(),
         pa.uint8(), pa.uint16(), pa.uint32(), pa.uint64(), pa.float16(),
         pa.float32(), pa.float64(), pa.string(), pa.large_string(),
         pa.binary(), pa.large_binary(), pa.date32(), pa.date64(),
         pa.timestamp("us"), pa.timestamp("ns", "UTC"), pa.time32("s"),
         pa.time64("us"), pa.duration("ms"), pa.decimal128(15, 2),
         pa.decimal256(60, 6), pa.month_day_nano_interval(),
         pa.list_(pa.int64()), pa.large_list(pa.string()),
         pa.list_(pa.float64(), 3), pa.struct([("a", pa.int64())]),
         pa.map_(pa.string(), pa.int64()),
         pa.union([pa.field("i", pa.int64())], "sparse"),
         pa.union([pa.field("i", pa.int64())], "dense"),
         pa.dictionary(pa.int32(), pa.string())]
PREDICATES = sorted(n for n in dir(ref_types) if n.startswith("is_")
                    and not n.endswith("_value"))
# where the JAX package is wrong against pyarrow (ROADMAP Queue 3): it
# cannot map large_binary, and counts no interval as primitive
PYARROW_DECIDES = {(str(pa.large_binary()), n) for n in PREDICATES} | {
    (str(pa.month_day_nano_interval()), "is_primitive")}


def _port_type(t):
    if pat.is_dictionary(t):   # the port's ingest keeps the value type
        return dt.dictionary(dt.from_arrow(t.index_type),
                             dt.from_arrow(t.value_type))
    return dt.from_arrow(t)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's predicates over every type, and its profiler's
    records of the calls the port's twin makes, computed once."""
    preds = {}
    for t in TYPES:
        for name in PREDICATES:
            try:
                preds[str(t), name] = getattr(ref_types, name)(
                    ref_dt.from_arrow(t))
            except TypeError:
                preds[str(t), name] = None
    a = a1t.column(np.arange(10000, dtype=np.int64))
    b = a1t.column(np.ones(10000, dtype=np.int64))
    with RefProfiler() as prof:
        ac.add(a, b)
        ac.multiply(a, b)
    return {"preds": preds,
            "prof": [(r.name, r.bytes_in, r.bytes_out) for r in prof.records]}


@pytest.mark.parametrize("t", TYPES, ids=str)
def test_type_predicates_match_the_reference(jax_results, t):
    for name in PREDICATES:
        port = getattr(port_types, name)
        got = (port(t), port(_port_type(t)))
        want = getattr(pat, name)(t) if hasattr(pat, name) else \
            jax_results["preds"][str(t), name]
        if (str(t), name) not in PYARROW_DECIDES:
            assert jax_results["preds"][str(t), name] == want, (t, name)
        assert got == (want, want), (t, name)


def test_value_predicates():
    for name in ("is_boolean_value", "is_integer_value", "is_float_value"):
        for v in (True, np.bool_(False), 3, np.int32(4), 2.5,
                  np.float32(1.0), "x"):
            assert getattr(port_types, name)(v) == \
                getattr(ref_types, name)(v), (name, v)


def test_stop_token():
    src = StopSource()
    tok = src.token()
    tok.poll()  # no-op
    src.request_stop("user abort")
    assert tok.is_stop_requested()
    with pytest.raises(CancelledError, match="user abort"):
        tok.poll()
    src.reset()
    tok.poll()


# ---- thread pool (twins of tests/test_thread_pool.py) ---------------------

def test_future_result_and_callback():
    f = Future()
    seen = []
    f.add_callback(lambda fut: seen.append(fut.result()))
    f.mark_finished(42)
    assert f.result() == 42
    assert seen == [42]
    f.add_callback(lambda fut: seen.append("late"))
    assert seen == [42, "late"]


def test_future_errors_and_chains():
    f = Future()
    f.mark_error(ValueError("boom"))
    with pytest.raises(ValueError):
        f.result()
    assert isinstance(f.exception(), ValueError)
    with pytest.raises(Invalid):
        f.mark_finished(2)
    f = Future()
    g = f.then(lambda v: v * 2).then(lambda v: v + 1)
    f.mark_finished(10)
    assert g.result(timeout=5) == 21
    f = Future()
    g = f.then(lambda v: v, on_error=lambda e: "recovered")
    f.mark_error(RuntimeError("x"))
    assert g.result(timeout=5) == "recovered"


def test_pool_submit_errors_and_parallelism():
    with ThreadPool(4) as pool:
        futs = [pool.submit(lambda x: x * x, i) for i in range(20)]
        assert [f.result(timeout=10) for f in futs] == [
            i * i for i in range(20)]
        t0 = time.perf_counter()
        futs = [pool.submit(time.sleep, 0.1) for _ in range(4)]
        for f in futs:
            f.result(timeout=10)
        assert time.perf_counter() - t0 < 0.3
        with pytest.raises(ZeroDivisionError):
            pool.submit(lambda: 1 / 0).result(timeout=10)


def test_pool_capacity_and_shutdown():
    pool = ThreadPool(1)
    try:
        pool.set_capacity(4)
        assert pool.capacity == 4
        t0 = time.perf_counter()
        for f in [pool.submit(time.sleep, 0.1) for _ in range(4)]:
            f.result(timeout=10)
        assert time.perf_counter() - t0 < 0.3
        pool.set_capacity(1)
        assert pool.capacity == 1
        with pytest.raises(Invalid):
            pool.set_capacity(0)
    finally:
        pool.shutdown()
    with pytest.raises(Invalid):
        pool.submit(lambda: None)
    pool = ThreadPool(2)
    done = []
    for i in range(8):
        pool.submit(lambda i=i: (time.sleep(0.01), done.append(i)))
    pool.shutdown(wait=True)
    assert len(done) == 8
    assert cpu_thread_pool() is cpu_thread_pool()
    assert cpu_thread_pool().submit(lambda: "ok").result(timeout=10) == "ok"


def test_task_groups():
    hits = []
    lock = threading.Lock()
    with TaskGroup() as tg:
        for i in range(16):
            def task(i=i):
                with lock:
                    hits.append(i)
            tg.append(task)
    assert sorted(hits) == list(range(16))
    tg = TaskGroup()
    tg.append(lambda: time.sleep(0.01))
    tg.append(lambda: (_ for _ in ()).throw(RuntimeError("first")))
    with pytest.raises(RuntimeError):
        tg.finish()
    assert not tg.ok()
    ran = []
    tg = TaskGroup(threaded=False)
    tg.append(lambda: (_ for _ in ()).throw(ValueError("e")))
    tg.append(lambda: ran.append(1))
    with pytest.raises(ValueError):
        tg.finish()
    assert ran == []
    order = []
    tg = TaskGroup(threaded=False)
    tg.append(lambda: order.append(1))
    tg.append(lambda: order.append(2))
    tg.finish()
    assert order == [1, 2]
    with pytest.raises(Invalid):
        tg.append(lambda: None)
    tg = TaskGroup()
    tg.append(time.sleep, 0.02)
    assert tg.finish_async().result(timeout=10) is None
    assert parallel_map(lambda x: x * 3, range(50)) == \
        [x * 3 for x in range(50)]


def test_parallel_map_stress_under_a_short_switch_interval():
    """More workers than cores, a shortened switch interval: a counter
    under the pool's futures loses no update."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    counter = [0]
    lock = threading.Lock()

    def bump(_):
        for _ in range(200):
            with lock:
                counter[0] += 1

    try:
        with ThreadPool(16) as pool:
            for f in [pool.submit(bump, i) for i in range(32)]:
                f.result(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert counter[0] == 32 * 200


# ---- memory pools, streams, codecs ---------------------------------------

def test_memory_pools():
    base = MemoryPool()
    proxy = ProxyMemoryPool(base)
    proxy.allocate(100)
    assert proxy.bytes_allocated == 100 and base.bytes_allocated == 100
    proxy.free(100)
    assert proxy.bytes_allocated == 0
    sink = io.StringIO()
    logp = LoggingMemoryPool(MemoryPool(), sink=sink)
    logp.allocate(64)
    assert "Allocate: size = 64" in sink.getvalue()
    assert logp.max_memory == 64
    assert pt.system_memory_pool() is pt.default_memory_pool()
    assert pt.supported_memory_backends() == ["system"]
    pt.log_memory_allocations(True)
    assert isinstance(pt.default_memory_pool(), LoggingMemoryPool)
    pt.log_memory_allocations(False)
    assert not isinstance(pt.default_memory_pool(), LoggingMemoryPool)
    with pytest.raises(NotImplementedError):
        pt.jemalloc_memory_pool()


def test_mmap_cache_and_buffered_streams(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(bytes(range(256)) * 16)
    with MemoryMappedFile(str(p)) as mm:
        assert mm.size() == 4096
        assert mm.read_at(256, 4).tobytes() == bytes(range(4))
    rc = ReadRangeCache(io.BytesIO(b"z" * 10000), hole_size_limit=64)
    rc.cache([(0, 100), (120, 50), (9000, 10)])
    assert rc.num_fetches == 2
    assert rc.read(130, 8) == b"z" * 8
    q = tmp_path / "b.bin"
    with BufferedOutputStream(str(q)) as out:
        out.write(b"hello")
    with BufferedInputStream(str(q)) as inp:
        assert inp.read() == b"hello"
    r = BufferReader(b"abc")
    assert r.read(2) == b"ab"
    with pytest.raises(Invalid):
        r.write(b"x")
    o = BufferOutputStream()
    o.write(b"xy")
    assert o.getvalue() == b"xy"


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_codecs_and_compressed_streams(tmp_path, codec):
    data = b"registry" * 1000
    c = Codec(codec)
    comp = c.compress(data)
    assert len(comp) < len(data)
    assert c.decompress(comp, len(data)) == data
    assert c.decompress(comp) == data   # the frame's content size
    assert decompress(compress(data, codec), codec) == data
    assert pa.Codec(codec).decompress(comp, len(data)).to_pybytes() == data
    path = tmp_path / f"s.{codec}"
    with output_stream(str(path), compression=codec) as out:
        out.write(data)
        out.write(b"tail")
    with input_stream(str(path), compression=codec) as inp:
        assert inp.read() == data + b"tail"


def test_zstd_without_zstandard_names_it(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(Invalid, match="zstandard"):
        Codec("zstd")


# ---- runtime and timing ---------------------------------------------------

def test_build_and_runtime_info():
    bi = pt.build_info()
    assert bi.version and bi.torch_version == torch.__version__
    assert bi.pyarrow_version == pa.__version__ and bi.native_library
    ri = pt.runtime_info(device="cpu")
    assert (ri.backend, ri.device_count, ri.x64_enabled) == ("cpu", 1, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.runtime_info()
    assert runtime.device_memory_stats("cpu") == {}
    with runtime.MemoryLog("cpu") as log:
        pt.record_batch({"x": np.arange(1000)}, device="cpu")
    assert log.delta == {}
    assert pt.total_allocated_bytes("cpu") == 0
    out = io.StringIO()
    import contextlib

    with contextlib.redirect_stdout(out):
        pt.show_versions()
    assert "torch" in out.getvalue() and "jax" not in out.getvalue()


def test_device_memory_stats_read_the_caching_allocator(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 10, "allocated_bytes.all.peak": 30,
        "reserved_bytes.all.current": 64, "allocation.all.allocated": 3})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 80})())
    assert runtime.device_memory_stats() == {
        "bytes_in_use": 10, "peak_bytes_in_use": 30, "bytes_limit": 80,
        "bytes_reserved": 64, "num_allocs": 3}


def test_timed_device_on_the_cpu():
    x = torch.arange(10000, dtype=torch.float64)
    assert timed_device(torch.sum, x, device="cpu") > 0
    with pytest.raises(RuntimeError, match="CUDA"):
        timed_device(torch.sum, x)


# ---- the profiler (twins of tests/test_profiler.py) -----------------------

def _col(values):
    return pt.interop.column_from_numpy(np.asarray(values), device="cpu")


def test_profiler_records_eager_dispatches(jax_results):
    a = _col(np.arange(10000, dtype=np.int64))
    b = _col(np.ones(10000, dtype=np.int64))
    with KernelProfiler("cpu") as prof:
        pc.add(a, b)
        pc.multiply(a, b)
    got = [(r.name, r.bytes_in, r.bytes_out) for r in prof.records]
    assert got == jax_results["prof"]
    assert all(r.wall_s > 0 for r in prof.records)


def test_profiler_inactive_and_nested():
    a = _col([1, 2, 3])
    with KernelProfiler("cpu") as prof:
        pass
    pc.add(a, a)
    assert prof.records == []
    with KernelProfiler("cpu") as outer:
        pc.add(a, a)
        with KernelProfiler("cpu") as inner:
            pc.negate(a)
        pc.add(a, a)
    assert [r.name for r in outer.records] == ["add", "add"]
    assert [r.name for r in inner.records] == ["negate"]


def test_profiler_summary_report_and_batches():
    a = _col(np.arange(4096, dtype=np.float64))
    with KernelProfiler("cpu") as prof:
        for _ in range(3):
            pc.add(a, a)
        pc.sum(a)
    by_name = {r["kernel"]: r for r in prof.summary()}
    assert by_name["add"]["calls"] == 3 and by_name["add"]["mb_moved"] > 0
    assert 0 <= by_name["add"]["best_roofline_frac"]
    assert "add" in prof.report() and "roof%" in prof.report()
    rb = pt.record_batch({"x": np.arange(1000, dtype=np.int64),
                          "y": np.arange(1000, dtype=np.float64)},
                         device="cpu")
    mask = _col(np.arange(1000) % 2 == 0)
    with KernelProfiler("cpu") as prof:
        kept = pc.filter(rb, mask)
    (r,) = prof.records
    assert r.name == "filter"
    assert r.bytes_in == 16000 + 1000
    assert r.bytes_out == sum(c.data.numel() * c.data.element_size()
                              for c in kept.columns)


def test_profiler_bytes_walk_nested_columns():
    arr = pa.array([{"a": [1, None, 3], "b": 1.5}, None,
                    {"a": [], "b": None}])
    col = pt.interop.column_from_arrow(arr, device="cpu")
    rb = pt.RecordBatch((col, _col(np.arange(3, dtype=np.int32))),
                        ("s", "i"))
    lst, flt = col.children
    want = [col.validity, lst.offsets, lst.values.data, lst.values.validity,
            lst.validity, flt.data, flt.validity]
    want = [t for t in want if t is not None]
    got = profiler.tensors_of(col)
    assert sorted(map(id, got)) == sorted(map(id, want))
    assert len(profiler.tensors_of([rb, (7, rb)])) == 2 * len(want) + 2
    assert profiler.tensors_of(None) == []


def test_roofline_math_and_peaks(monkeypatch):
    r = KernelRecord("x", wall_s=0.001, bytes_in=40_000_000,
                     bytes_out=10_000_000)
    assert abs(r.roofline_frac(50e9) - 1.0) < 1e-9
    assert hbm_peak_bytes_per_sec("cpu") == 50e9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, rate in (("NVIDIA H100 80GB HBM3", 3.35e12),
                       ("NVIDIA H100 PCIe", 2.0e12),
                       ("NVIDIA H100 NVL", 3.9e12),
                       ("NVIDIA H200", 4.8e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None, name=name: name)
        assert hbm_peak_bytes_per_sec() == rate, name
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "Some Other GPU")
    with pytest.raises(RuntimeError, match="no HBM bandwidth"):
        hbm_peak_bytes_per_sec()
    assert profiler.HBM_PEAK[0][0] == "H100 PCIe"
