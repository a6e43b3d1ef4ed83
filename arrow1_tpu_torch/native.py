"""ctypes binding for the repository's native host runtime (``native/src``;
counterpart of arrow1_tpu/native.py).

Components (see native/src/*.cpp):
- shared-memory object store  <- cpp/src/plasma/
- hash + memo table           <- cpp/src/arrow/util/hashing.h
- LZ4 block and frame codecs  <- cpp/src/arrow/util/compression_lz4.cc
- ragged dictionary gather (the IPC writer's string materialization)
  and Parquet's PLAIN byte-array encoder
- Snappy block decoder          <- the codec Parquet and ORC pages use
- the C data interface's release callbacks and a C consumer of it
                                <- cpp/src/arrow/c/bridge.cc

The library is built at first use with the C++ compiler (``$CXX``, else
``g++``): one compile of each ``native/src/*.cpp`` at once, then one link
(``-lrt -lpthread``), into
``build/arrow1_tpu_torch/native-<hash of the sources and flags>.so`` at the
root of the checkout. There is no cmake step and ``native/build`` is not
read. If the compiler is missing or a source fails to build,
``native_available()`` is False, the build's output is kept beside the
library as ``.log``, and the callers take their pure-Python paths or
raise, as the JAX package's do. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["native_available", "load_library", "library_path", "hash_bytes",
           "MemoTable", "lz4_frame_compress", "lz4_frame_decompress",
           "lz4_block_decompress", "ragged_gather", "snappy_decompress",
           "plain_byte_array"]

_ROOT = Path(__file__).resolve().parents[1]
NATIVE_SRC = _ROOT / "native" / "src"
BUILD_DIR = _ROOT / "build" / "arrow1_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC")
LINK_FLAGS = ("-shared", "-lrt", "-lpthread")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _sources():
    return sorted(NATIVE_SRC.glob("*.cpp"))


def library_path() -> Path:
    """Where the library lives, keyed on every source and header of
    ``native/src`` and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for p in sorted(NATIVE_SRC.iterdir()):
        if p.suffix in (".cpp", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile every source at once, link, and move the library into
    place atomically (a concurrent builder's copy is as good)."""
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if not cxx:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        try:
            for src in _sources():
                obj = Path(tmp) / f"{src.stem}.o"
                procs.append((src, obj, subprocess.Popen(
                    [cxx, *CXX_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            ok = True
            for src, _, proc in procs:
                text, _ = proc.communicate()
                log.append(f"{src.name}: exit {proc.returncode}\n{text}")
                ok = ok and proc.returncode == 0
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if ok:
            lib = Path(tmp) / out.name
            link = subprocess.run(
                [cxx, "-o", str(lib), *(str(o) for _, o, _ in procs),
                 *LINK_FLAGS], capture_output=True, text=True)
            log.append(f"link: exit {link.returncode}\n{link.stdout}"
                       f"{link.stderr}")
            ok = link.returncode == 0
            if ok:
                os.replace(lib, out)
    out.with_suffix(".log").write_text("\n".join(log))
    return ok


def _bind(lib: ctypes.CDLL) -> None:
    c_void_p, c_char_p = ctypes.c_void_p, ctypes.c_char_p
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
    sigs = {
        # store API
        "a1t_store_create": (c_void_p, [c_char_p, u64, u64]),
        "a1t_store_open": (c_void_p, [c_char_p]),
        "a1t_create": (c_void_p, [c_void_p, c_char_p, u64]),
        "a1t_seal": (ctypes.c_int, [c_void_p, c_char_p]),
        "a1t_get": (c_void_p, [c_void_p, c_char_p,
                               ctypes.POINTER(u64)]),
        "a1t_release": (ctypes.c_int, [c_void_p, c_char_p]),
        "a1t_delete": (ctypes.c_int, [c_void_p, c_char_p]),
        "a1t_contains": (ctypes.c_int, [c_void_p, c_char_p]),
        "a1t_list": (u64, [c_void_p, c_void_p, u64]),
        "a1t_store_bytes_used": (u64, [c_void_p]),
        "a1t_store_evictions": (u64, [c_void_p]),
        "a1t_store_close": (None, [c_void_p]),
        "a1t_store_destroy": (None, [c_char_p]),
        # hash and memo table API
        "a1t_hash_bytes": (u64, [c_char_p, u64]),
        "a1t_hash_binary_array": (None, [c_void_p, c_void_p, i64,
                                         c_void_p]),
        "a1t_memo_create": (c_void_p, [u64]),
        "a1t_memo_destroy": (None, [c_void_p]),
        "a1t_memo_size": (i32, [c_void_p]),
        "a1t_memo_get_or_insert": (i32, [c_void_p, c_char_p, u64]),
        "a1t_memo_lookup": (i32, [c_void_p, c_char_p, u64]),
        "a1t_memo_encode_array": (None, [c_void_p, c_void_p, c_void_p, i64,
                                         c_void_p]),
        "a1t_memo_values": (c_void_p, [c_void_p, c_void_p]),
        # lz4 codec API
        "a1t_lz4_frame_max_compressed": (i64, [i64]),
        # ragged dictionary gather (codes, u_starts, pool -> var-binary)
        "a1t_ragged_gather": (i64, [c_void_p, i64] + [c_void_p] * 5 + [i64]),
        "a1t_ragged_gather64": (i64, [c_void_p, i64] + [c_void_p] * 5
                                + [i64]),
        # parquet PLAIN byte-array encode (codes, u_starts, pool -> bytes)
        "a1t_plain_byte_array": (i64, [c_void_p, i64] + [c_void_p] * 4
                                 + [i64]),
        # the C data interface's release callbacks and its C consumer
        "a1t_cabi_release_schema": (None, [c_void_p]),
        "a1t_cabi_release_array": (None, [c_void_p]),
        "a1t_cabi_drain": (i64, [c_void_p, i64]),
        "a1t_cabi_consume": (i64, [c_void_p, c_void_p, c_void_p]),
        # snappy block format
        "a1t_snappy_uncompressed_len": (i64, [c_char_p, i64]),
        "a1t_snappy_decompress": (i64, [c_char_p, i64, c_char_p, i64]),
    }
    for fn in ("a1t_lz4_block_compress", "a1t_lz4_block_decompress",
               "a1t_lz4_frame_compress", "a1t_lz4_frame_decompress"):
        sigs[fn] = (i64, [c_char_p, i64, c_char_p, i64])
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it cannot be
    built (tried once a process)."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        _lib = lib
    return _lib


def native_available() -> bool:
    return load_library() is not None


def _require():
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable: no C++ compiler, or "
                           f"the build failed (see {library_path()}"
                           ".log)")
    return lib


def lz4_frame_compress(data) -> bytes:
    """LZ4 frame compression (native/src/lz4.cpp: block and frame format,
    content size recorded)."""
    lib = _require()
    data = bytes(data)
    cap = int(lib.a1t_lz4_frame_max_compressed(len(data)))
    out = ctypes.create_string_buffer(cap)
    n = lib.a1t_lz4_frame_compress(data, len(data), out, cap)
    if n < 0:
        raise RuntimeError("lz4 frame compress failed")
    return out.raw[:n]


def lz4_frame_decompress(data, uncompressed_size: int) -> bytes:
    lib = _require()
    data = bytes(data)
    out = ctypes.create_string_buffer(max(uncompressed_size, 1))
    n = lib.a1t_lz4_frame_decompress(data, len(data), out,
                                     uncompressed_size)
    if n < 0:
        raise RuntimeError("lz4 frame decompress failed (malformed input)")
    return out.raw[:n]


def lz4_block_decompress(data, max_size: int) -> bytes:
    """Raw LZ4 block decompress."""
    lib = _require()
    data = bytes(data)
    out = ctypes.create_string_buffer(max(max_size, 1))
    n = lib.a1t_lz4_block_decompress(data, len(data), out, max_size)
    if n < 0:
        raise RuntimeError("lz4 block decompress failed (malformed)")
    return out.raw[:n]


def hash_bytes(data: bytes) -> int:
    lib = load_library()
    if lib is None:
        return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                              "little")
    return int(lib.a1t_hash_bytes(data, len(data)))


class MemoTable:
    """bytes -> dense id in insertion order (reference: util/hashing.h:605
    BinaryMemoTable). Falls back to a Python dict when the native library
    is unavailable."""

    def __init__(self, initial_capacity: int = 64):
        self._lib = load_library()
        if self._lib is not None:
            self._handle = self._lib.a1t_memo_create(initial_capacity)
            self._fallback = None
        else:
            self._handle = None
            self._fallback = {}
            self._values = []

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib:
            self._lib.a1t_memo_destroy(self._handle)
            self._handle = None

    def get_or_insert(self, value: bytes) -> int:
        if self._handle is not None:
            return int(self._lib.a1t_memo_get_or_insert(
                self._handle, value, len(value)))
        if value not in self._fallback:
            self._fallback[value] = len(self._values)
            self._values.append(value)
        return self._fallback[value]

    def lookup(self, value: bytes) -> int:
        if self._handle is not None:
            return int(self._lib.a1t_memo_lookup(self._handle, value,
                                                 len(value)))
        return self._fallback.get(value, -1)

    def __len__(self):
        if self._handle is not None:
            return int(self._lib.a1t_memo_size(self._handle))
        return len(self._values)

    def encode_array(self, data: np.ndarray, offsets: np.ndarray
                     ) -> np.ndarray:
        """Bulk dictionary-encode an arrow var-binary buffer pair.

        Offsets are validated here: the C side dereferences them raw, so
        hostile wire input must be rejected at this boundary."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        data = np.ascontiguousarray(data, dtype=np.uint8)
        n = len(offsets) - 1
        if n < 0 or (n and (offsets[0] < 0
                            or np.any(np.diff(offsets) < 0)
                            or int(offsets[-1]) > data.size)):
            raise ValueError("memo.encode_array: corrupt offsets")
        ids = np.empty(n, dtype=np.int32)
        if self._handle is not None:
            self._lib.a1t_memo_encode_array(
                self._handle, data.ctypes.data_as(ctypes.c_void_p),
                offsets.ctypes.data_as(ctypes.c_void_p), n,
                ids.ctypes.data_as(ctypes.c_void_p))
        else:
            for i in range(n):
                ids[i] = self.get_or_insert(
                    bytes(data[offsets[i]:offsets[i + 1]]))
        return ids

    def values(self):
        """All distinct values in insertion order, as a list of bytes."""
        if self._handle is None:
            return list(self._values)
        n = len(self)
        offsets = np.empty(n + 1, dtype=np.int64)
        ptr = self._lib.a1t_memo_values(
            self._handle, offsets.ctypes.data_as(ctypes.c_void_p))
        total = int(offsets[-1])
        buf = ctypes.string_at(ptr, total) if total else b""
        return [buf[offsets[i]:offsets[i + 1]] for i in range(n)]


def ragged_gather(codes, u_starts, pool, row_valid, total: int,
                  large: bool = False):
    """Dictionary codes + unique pool -> (offsets, data) var-binary
    buffers (native/src/ragged.cpp). ``total`` is the exact payload size.
    None when the library is unavailable or the sizes disagree."""
    lib = load_library()
    if lib is None:
        return None
    fn = lib.a1t_ragged_gather64 if large else lib.a1t_ragged_gather
    n = len(codes)
    codes = np.ascontiguousarray(codes, np.int64)
    u_starts = np.ascontiguousarray(u_starts, np.int64)
    pool = np.ascontiguousarray(pool, np.uint8)
    offsets = np.empty(n + 1, np.int64 if large else np.int32)
    data = np.empty(max(total, 1), np.uint8)
    rv = None if row_valid is None else \
        np.ascontiguousarray(row_valid, np.uint8)
    got = fn(codes.ctypes.data, n, u_starts.ctypes.data, pool.ctypes.data,
             None if rv is None else rv.ctypes.data, offsets.ctypes.data,
             data.ctypes.data, total)
    if got != total:
        return None
    return offsets, data[:total]


def snappy_decompress(data, uncompressed_size: Optional[int] = None
                      ) -> bytes:
    """Snappy block decompress (native/src/snappy.cpp). The output size is
    the stream's preamble, which must equal ``uncompressed_size`` where the
    caller knows it; malformed input raises ``ValueError``."""
    lib = _require()
    data = bytes(data)
    usize = int(lib.a1t_snappy_uncompressed_len(data, len(data)))
    if usize < 0 or (uncompressed_size is not None
                     and usize != uncompressed_size):
        raise ValueError(f"snappy: bad preamble ({usize} bytes, "
                         f"{uncompressed_size} expected)")
    out = ctypes.create_string_buffer(max(usize, 1))
    n = lib.a1t_snappy_decompress(data, len(data), out, usize)
    if n != usize:
        raise ValueError("snappy decompress failed (malformed input)")
    return out.raw[:n]


def plain_byte_array(codes, u_starts, pool, row_valid, cap: int):
    """Parquet PLAIN byte-array encode (native/src/ragged.cpp): each kept
    row's value as <u32 LE length><bytes>. Raises ``RuntimeError`` when
    the library is unavailable and ``ValueError`` when ``cap`` bytes are
    too few."""
    lib = _require()
    codes = np.ascontiguousarray(codes, np.int64)
    u_starts = np.ascontiguousarray(u_starts, np.int64)
    pool = np.ascontiguousarray(pool, np.uint8)
    rv = None if row_valid is None else \
        np.ascontiguousarray(row_valid, np.uint8)
    out = np.empty(max(cap, 1), np.uint8)
    got = lib.a1t_plain_byte_array(
        codes.ctypes.data, len(codes), u_starts.ctypes.data,
        pool.ctypes.data, None if rv is None else rv.ctypes.data,
        out.ctypes.data, cap)
    if got < 0:
        raise ValueError(f"plain_byte_array: {cap} bytes are too few")
    return out[:got].tobytes()
