"""pyarrow.csv-shaped module over the native C++ parser (counterpart of
arrow1_tpu/csv.py; reference: python/pyarrow/csv.py, read_csv, open_csv
and write_csv with ReadOptions, ParseOptions, ConvertOptions and
WriteOptions). ``import arrow1_tpu_torch.csv as csv`` ports 1:1. Readers
take ``device=`` (CUDA unless the caller names the CPU)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .io.csv import open_csv_stream, read_csv as _read_csv, write_csv

__all__ = ["ReadOptions", "ParseOptions", "ConvertOptions", "WriteOptions",
           "read_csv", "open_csv", "write_csv"]


@dataclasses.dataclass
class ReadOptions:
    """Reference: csv/options.h ReadOptions."""
    use_threads: bool = True
    block_size: int = 1 << 20
    skip_rows: int = 0
    skip_rows_after_names: int = 0
    column_names: Optional[Sequence[str]] = None
    autogenerate_column_names: bool = False
    encoding: str = "utf8"


@dataclasses.dataclass
class ParseOptions:
    """Reference: csv/options.h ParseOptions."""
    delimiter: str = ","
    quote_char: object = '"'
    double_quote: bool = True
    escape_char: object = False
    newlines_in_values: bool = False
    ignore_empty_lines: bool = True


@dataclasses.dataclass
class ConvertOptions:
    """Reference: csv/options.h ConvertOptions."""
    check_utf8: bool = True
    column_types: object = None
    null_values: object = None
    true_values: object = None
    false_values: object = None
    strings_can_be_null: bool = False
    quoted_strings_can_be_null: bool = True
    include_columns: object = None
    include_missing_columns: bool = False
    auto_dict_encode: bool = False
    timestamp_parsers: object = None


@dataclasses.dataclass
class WriteOptions:
    """Reference: csv/options.h WriteOptions."""
    include_header: bool = True
    batch_size: int = 1024
    delimiter: str = ","


def read_csv(input_file, read_options=None, parse_options=None,
             convert_options=None, device=None):
    """pyarrow.csv.read_csv's shape -> Table. The native parser reads the
    dataclasses' options itself; all-default ConvertOptions keep it."""
    if convert_options == ConvertOptions():
        convert_options = None
    return _read_csv(input_file, read_options=read_options,
                     parse_options=parse_options,
                     convert_options=convert_options, device=device)


def open_csv(input_file, read_options=None, parse_options=None,
             convert_options=None, device=None):
    """pyarrow.csv.open_csv's shape -> an iterator of batches."""
    if read_options is None and parse_options is None and \
            convert_options is None:
        return open_csv_stream(input_file, device=device)
    table = read_csv(input_file, read_options, parse_options,
                     convert_options, device=device)
    batch = table.combine_chunks()
    step = 1 << 16
    return iter([batch.slice(lo, step)
                 for lo in range(0, max(batch.num_rows, 1), step)])
