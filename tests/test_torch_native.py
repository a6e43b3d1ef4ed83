"""The port's native host runtime (arrow1_tpu_torch/native.py, built from
native/src with g++) against the JAX package's binding of the same
sources (arrow1_tpu/native.py): LZ4 block and frame bytes, hash_bytes,
the MemoTable's codes and values and ragged_gather, on the same seeded
numpy inputs; LZ4 frames against pyarrow's codec both ways; malformed
frames raise and never crash; a missing compiler turns the library off
instead of failing an import."""

import ctypes

import numpy as np
import pyarrow as pa
import pytest

from arrow1_tpu import native as ref
from arrow1_tpu_torch import native

RNG_SEED = 17


def _inputs():
    rng = np.random.default_rng(RNG_SEED)
    words = [b"alpha", b"beta", b"", b"gamma\x00", "é".encode()]
    pool = rng.choice(len(words), 500)
    data = b"".join(words[i] for i in pool)
    offsets = np.concatenate([[0], np.cumsum([len(words[i]) for i in pool])])
    return {
        "payloads": [b"", b"x", b"the quick brown fox " * 500 + bytes(
            range(256)), bytes(rng.integers(0, 256, 10000, dtype=np.uint8)),
            b"0123456789abcdef" * 20000],
        "strings": (np.frombuffer(data, np.uint8), offsets.astype(np.int64)),
        "codes": rng.integers(0, 4, 300),
        "row_valid": rng.random(300) > 0.2,
    }


def _block_compress(lib, data: bytes) -> bytes:
    cap = len(data) + len(data) // 255 + 16
    out = ctypes.create_string_buffer(max(cap, 1))
    n = lib.a1t_lz4_block_compress(data, len(data), out, cap)
    assert n >= 0
    return out.raw[:n]


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's binding on the same inputs, computed once."""
    if not ref.native_available():
        pytest.skip("the JAX package's native library did not build")
    inp = _inputs()
    lib = ref.load_library()
    data, offsets = inp["strings"]
    memo = ref.MemoTable(8)
    codes = memo.encode_array(data, offsets)
    values = [b"w0", b"", b"longer value", b"\xff\xfe"]
    u_starts = np.concatenate([[0], np.cumsum([len(v) for v in values])])
    lens = np.array([len(v) for v in values])[inp["codes"]]
    total = int(lens[inp["row_valid"]].sum())
    return {
        "frames": [ref.lz4_frame_compress(p) for p in inp["payloads"]],
        "blocks": [_block_compress(lib, p) for p in inp["payloads"]],
        "hashes": [ref.hash_bytes(p) for p in inp["payloads"]],
        "memo": (codes, memo.values(), len(memo)),
        "ragged": [ref.ragged_gather(inp["codes"], u_starts, np.frombuffer(
            b"".join(values), np.uint8), valid, total if valid is not None
            else int(lens.sum()), large=large)
            for valid in (inp["row_valid"], None) for large in (False,
                                                                True)],
        "ragged_args": (u_starts, b"".join(values), int(lens.sum()), total),
        "inputs": inp,
    }


def test_library_builds_from_native_src():
    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("native-")
    assert "native/build" not in str(path)


@pytest.mark.parametrize("i", range(5))
def test_lz4_frame_bytes_equal_the_reference(jax_results, i):
    payload = jax_results["inputs"]["payloads"][i]
    frame = native.lz4_frame_compress(payload)
    assert frame == jax_results["frames"][i]
    assert native.lz4_frame_decompress(frame, len(payload)) == payload
    assert ref.lz4_frame_decompress(frame, len(payload)) == payload


@pytest.mark.parametrize("i", range(5))
def test_lz4_block_bytes_equal_the_reference(jax_results, i):
    payload = jax_results["inputs"]["payloads"][i]
    block = _block_compress(native.load_library(), payload)
    assert block == jax_results["blocks"][i]
    assert native.lz4_block_decompress(block, len(payload)) == payload


def test_hash_bytes_equal_the_reference(jax_results):
    got = [native.hash_bytes(p) for p in jax_results["inputs"]["payloads"]]
    assert got == jax_results["hashes"]


def test_memo_table_equals_the_reference(jax_results):
    data, offsets = jax_results["inputs"]["strings"]
    memo = native.MemoTable(8)
    codes = memo.encode_array(data, offsets)
    want_codes, want_values, want_len = jax_results["memo"]
    assert codes.dtype == np.int32 and np.array_equal(codes, want_codes)
    assert memo.values() == want_values and len(memo) == want_len
    assert memo.lookup(b"beta") == want_values.index(b"beta")
    assert memo.lookup(b"absent") == -1
    assert memo.get_or_insert(b"new") == want_len
    with pytest.raises(ValueError, match="corrupt offsets"):
        memo.encode_array(data, np.array([0, 5, 3], np.int64))


def test_ragged_gather_equals_the_reference(jax_results):
    inp = jax_results["inputs"]
    u_starts, pool, total_all, total_valid = jax_results["ragged_args"]
    got = [native.ragged_gather(inp["codes"], u_starts,
                                np.frombuffer(pool, np.uint8), valid,
                                total_valid if valid is not None
                                else total_all, large=large)
           for valid in (inp["row_valid"], None) for large in (False, True)]
    for (go, gd), (wo, wd) in zip(got, jax_results["ragged"]):
        assert go.dtype == wo.dtype and np.array_equal(go, wo)
        assert np.array_equal(gd, wd)
    # a wrong total is refused, not overrun
    assert native.ragged_gather(inp["codes"], u_starts,
                                np.frombuffer(pool, np.uint8), None,
                                total_all - 1) is None


def test_pyarrow_reads_our_frames_and_we_read_its_linked_blocks():
    codec = pa.Codec("lz4")
    data = b"abcabcabc" * 10000
    assert codec.decompress(pa.py_buffer(native.lz4_frame_compress(data)),
                            len(data)).to_pybytes() == data
    linked = b"0123456789abcdef" * 20000   # matches cross 64 KB blocks
    comp = codec.compress(linked).to_pybytes()
    assert (comp[4] >> 5) & 1 == 0
    assert native.lz4_frame_decompress(comp, len(linked)) == linked


def test_malformed_frames_raise_and_never_crash():
    with pytest.raises(RuntimeError):
        native.lz4_frame_decompress(b"\x00\x01\x02\x03\x04\x05\x06\x07", 100)
    base = native.lz4_frame_compress(b"payload " * 1000)
    rng = np.random.default_rng(3)
    for _ in range(300):
        data = bytearray(base)
        for _ in range(rng.integers(1, 4)):
            data[int(rng.integers(0, len(data)))] ^= \
                1 << int(rng.integers(0, 8))
        try:
            assert len(native.lz4_frame_decompress(bytes(data), 8000)) <= 8000
        except RuntimeError:
            pass
    base = native.lz4_frame_compress(b"abc" * 5000)
    for cut in range(0, len(base), max(1, len(base) // 50)):
        try:
            native.lz4_frame_decompress(base[:cut], 15000)
        except RuntimeError:
            pass


def test_no_compiler_turns_the_library_off(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "native-x.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.native_available()
    assert native.hash_bytes(b"abc") == native.hash_bytes(b"abc")
    memo = native.MemoTable()   # the pure-Python fallback
    assert memo.encode_array(np.frombuffer(b"abab", np.uint8),
                             np.array([0, 1, 2, 3, 4])).tolist() == \
        [0, 1, 0, 1]
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.lz4_frame_compress(b"x")
    assert not (tmp_path / "native-x.so").exists()
