"""Parquet reader and writer (counterpart of arrow1_tpu/io/parquet.py).

Reference: cpp/src/parquet/ (the read and write stack) and its Arrow
adapter (parquet/arrow/reader.h:107). The native path
(io/parquet_native.py: Thrift compact metadata, pages, the RLE hybrid,
dictionary, delta and byte-stream-split encodings, native snappy, nesting
to any depth, bloom filters and AES-GCM modular encryption) reads and
writes; ``filters=`` runs natively (the DNF as a port Expression, then a
row filter on the device), and projection (``columns=``) and row-group
selection push down into the decoder, so only the needed bytes are
decoded and moved to the device.

pyarrow.parquet is reached only for what the native path declines before
it reads or writes (``UnsupportedLayout``: BROTLI, LZO or LZ4 pages, a
column type the port has no layout for) and for files encrypted through
pyarrow's key management (``encryption_properties`` and
``decryption_properties`` handles). A corrupt or truncated file raises
``Invalid``; a missing path raises ``FileNotFoundError``. Readers take
``device=`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import io as _io
from typing import Iterator, Optional, Sequence, Union

from ..device import resolve_device
from ..table import RecordBatch, Table
from .csv import _as_bytes
from .ipc_native import UnsupportedLayout

__all__ = ["read_parquet", "write_parquet", "iter_parquet_batches",
           "encryption_properties", "decryption_properties", "InMemoryKms"]


class InMemoryKms:
    """Test and single-process KMS: wraps data keys by XOR with a named
    master key (reference: parquet/encryption/kms_client.h KmsClient; a
    deployment plugs a real KMS in here; the wrap format is the KMS's
    own)."""

    def __init__(self, master_keys):
        self._keys = {k: bytes(v) for k, v in master_keys.items()}

    def _factory(self, kms_connection_config=None):
        import base64

        import pyarrow.parquet.encryption as pe

        keys = self._keys

        class _Client(pe.KmsClient):
            def __init__(self):
                pe.KmsClient.__init__(self)

            def wrap_key(self, key_bytes, master_key_identifier):
                mk = keys[master_key_identifier]
                x = bytes(b ^ mk[i % len(mk)]
                          for i, b in enumerate(key_bytes))
                return base64.b64encode(x).decode()

            def unwrap_key(self, wrapped_key, master_key_identifier):
                mk = keys[master_key_identifier]
                x = base64.b64decode(wrapped_key)
                return bytes(b ^ mk[i % len(mk)] for i, b in enumerate(x))

        return _Client()


def encryption_properties(footer_key: str, column_keys=None,
                          master_keys=None,
                          algorithm: str = "AES_GCM_V1"):
    """Parquet modular encryption through pyarrow's key management
    (reference: parquet/encryption/encryption.h FileEncryptionProperties
    and crypto_factory.h). ``column_keys`` maps a master-key id to its
    columns, ``master_keys`` a key id to its 16, 24 or 32 bytes. The
    handle goes to ``write_parquet(encryption=...)``; a dict
    ``{"footer_key": bytes}`` there instead writes natively with that
    key."""
    import pyarrow.parquet.encryption as pe

    kms = InMemoryKms(master_keys or {})
    factory = pe.CryptoFactory(kms._factory)
    cfg = pe.EncryptionConfiguration(
        footer_key=footer_key, column_keys=column_keys or {},
        encryption_algorithm=algorithm)
    return {"factory": factory, "config": cfg,
            "kms_config": pe.KmsConnectionConfig()}


def decryption_properties(master_keys):
    """The reader's handle over the same master keys (reference:
    encryption.h FileDecryptionProperties)."""
    import pyarrow.parquet.encryption as pe

    kms = InMemoryKms(master_keys)
    factory = pe.CryptoFactory(kms._factory)
    return {"factory": factory, "config": pe.DecryptionConfiguration(),
            "kms_config": pe.KmsConnectionConfig()}


def _kms(handle) -> bool:
    return handle is not None and "factory" in handle


def _filters_to_expr(filters):
    """pyarrow-style DNF filters as a port Expression: [(c, op, v), ...]
    is a conjunction, [[...], [...]] an OR of them
    (python/pyarrow/parquet.py filters_to_expression)."""
    from ..expr import field

    def leaf(c, op, v):
        f = field(c)
        if op in ("=", "=="):
            return f == v
        if op == "!=":
            return f != v
        if op == "<":
            return f < v
        if op == ">":
            return f > v
        if op == "<=":
            return f <= v
        if op == ">=":
            return f >= v
        if op == "in":
            return f.isin(list(v))
        if op == "not in":
            return ~f.isin(list(v))
        raise ValueError(f"parquet filters: unsupported op {op!r}")

    if filters and isinstance(filters[0], tuple):
        filters = [filters]
    ors = None
    for conj in filters:
        ands = None
        for c, op, v in conj:
            e = leaf(c, op, v)
            ands = e if ands is None else (ands & e)
        ors = ands if ors is None else (ors | ands)
    return ors


def _referenced(expr, out=None) -> list:
    """The column names an Expression reads, in first-reference order."""
    from ..expr import Call, FieldRef

    out = [] if out is None else out
    if isinstance(expr, FieldRef) and expr.name not in out:
        out.append(expr.name)
    elif isinstance(expr, Call):
        for a in expr.args:
            _referenced(a, out)
    return out


def _pyarrow_table(src, dev, columns=None, filters=None, decryption=None):
    import pyarrow.parquet as pq

    from ..interop import record_batch_from_arrow

    dp = None
    if decryption is not None:
        dp = decryption["factory"].file_decryption_properties(
            decryption["kms_config"], decryption["config"])
    tbl = pq.read_table(src, columns=list(columns) if columns else None,
                        filters=filters, decryption_properties=dp)
    return Table([record_batch_from_arrow(tbl, device=dev)])


def read_parquet(path, columns: Optional[Sequence[str]] = None,
                 filters=None, decryption=None, device=None) -> Table:
    """A Parquet file (a path, bytes or a file object) as a one-batch
    Table on ``device``. ``decryption``: a ``decryption_properties``
    handle (pyarrow reads) or ``{"footer_key": bytes}`` (native)."""
    from ..ops.selection import filter as row_filter
    from .parquet_native import bloom_prune_row_groups, read_parquet_native

    dev = resolve_device(device)
    buf = _as_bytes(path)
    if _kms(decryption):
        return _pyarrow_table(_io.BytesIO(buf), dev, columns, filters,
                              decryption)
    expr = _filters_to_expr(filters) if filters else None
    # the filter may read columns outside the projection: read their
    # union, and project after the row filter
    need = None
    if columns is not None:
        need = list(columns)
        if expr is not None:
            need += [r for r in _referenced(expr) if r not in need]
    try:
        rg_keep = None
        if filters and buf[:4] == b"PAR1":
            # bloom-filter row-group skipping (parquet/bloom_filter.h)
            rg_keep = bloom_prune_row_groups(buf, filters)
        if rg_keep == []:
            # every row group pruned: a typed empty result
            rb = read_parquet_native(buf, columns=need, row_groups=[0],
                                     decryption=decryption,
                                     device=dev).slice(0, 0)
        else:
            rb = read_parquet_native(buf, columns=need, row_groups=rg_keep,
                                     decryption=decryption, device=dev)
    except UnsupportedLayout:
        return _pyarrow_table(_io.BytesIO(buf), dev, columns, filters)
    if expr is not None:
        rb = row_filter(rb, expr.execute(rb))
    if columns is not None and need != list(columns):
        rb = rb.select(list(columns))
    return Table([rb])


def iter_parquet_batches(path, columns: Optional[Sequence[str]] = None,
                         batch_rows: int = 1 << 20, device=None
                         ) -> Iterator[RecordBatch]:
    """Row-group-granular streaming read (reference: GetRecordBatchReader,
    parquet/arrow/reader.cc:257): one decode per row group, cut into
    batches of at most ``batch_rows`` rows, on ``device``. The footer of
    every row group is checked before anything is read, so a declined
    file goes to pyarrow whole."""
    from .parquet_native import native_row_groups, read_parquet_native

    dev = resolve_device(device)
    buf = _as_bytes(path)
    cols = list(columns) if columns else None
    try:
        n_rg = native_row_groups(buf, cols)
    except UnsupportedLayout:
        import pyarrow.parquet as pq

        from ..interop import record_batch_from_arrow

        pf = pq.ParquetFile(_io.BytesIO(buf))
        for batch in pf.iter_batches(batch_size=batch_rows, columns=cols):
            yield record_batch_from_arrow(batch, device=dev)
        return

    for i in range(n_rg):
        rb = read_parquet_native(buf, columns=cols, row_groups=[i],
                                 device=dev)
        for lo in range(0, rb.num_rows, batch_rows):
            yield rb.slice(lo, min(batch_rows, rb.num_rows - lo))


def write_parquet(data: Union[RecordBatch, Table], path,
                  compression: str = "snappy", row_group_size=None,
                  encryption=None, use_byte_stream_split: bool = False,
                  use_delta_binary_packed: bool = False,
                  bloom_filter_columns=None):
    """Write a RecordBatch or Table to a Parquet file (a path or a binary
    file object). ``encryption``: an ``encryption_properties`` handle
    (pyarrow writes) or ``{"footer_key": bytes}`` (native)."""
    from .parquet_native import write_parquet_native

    batch = data.combine_chunks() if isinstance(data, Table) else data
    if not _kms(encryption):
        sink = _io.BytesIO()
        try:
            write_parquet_native(
                batch, sink, compression=compression,
                row_group_size=row_group_size,
                use_byte_stream_split=use_byte_stream_split,
                use_delta_binary_packed=use_delta_binary_packed,
                bloom_filter_columns=bloom_filter_columns,
                encryption=encryption)
        except UnsupportedLayout:
            pass
        else:
            if hasattr(path, "write"):
                path.write(sink.getvalue())
            else:
                with open(path, "wb") as f:
                    f.write(sink.getvalue())
            return
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..interop import record_batch_to_arrow

    tbl = pa.Table.from_batches([record_batch_to_arrow(batch)])
    if encryption is not None:
        fep = encryption["factory"].file_encryption_properties(
            encryption["kms_config"], encryption["config"])
        with pq.ParquetWriter(path, tbl.schema, compression=compression,
                              encryption_properties=fep) as w:
            w.write_table(tbl, row_group_size=row_group_size)
        return
    pq.write_table(tbl, path, compression=compression,
                   row_group_size=row_group_size)
