"""pyarrow.json-shaped module over the native NDJSON parser (counterpart
of arrow1_tpu/json.py; reference: python/pyarrow/json.py, read_json with
ReadOptions and ParseOptions). ``import arrow1_tpu_torch.json as json``
ports 1:1. Readers take ``device=`` (CUDA unless the caller names the
CPU)."""

from __future__ import annotations

import dataclasses

from .io.json import read_json as _read_json

__all__ = ["ReadOptions", "ParseOptions", "read_json"]


@dataclasses.dataclass
class ReadOptions:
    """Reference: json/options.h ReadOptions."""
    use_threads: bool = True
    block_size: int = 1 << 20


@dataclasses.dataclass
class ParseOptions:
    """Reference: json/options.h ParseOptions."""
    explicit_schema: object = None
    newlines_in_values: bool = False
    unexpected_field_behavior: str = "infer"


def read_json(input_file, read_options=None, parse_options=None,
              device=None):
    """pyarrow.json.read_json's shape -> Table. Default options read
    natively; any other goes to pyarrow."""
    if read_options == ReadOptions():
        read_options = None
    if parse_options == ParseOptions():
        parse_options = None
    return _read_json(input_file, read_options=read_options,
                      parse_options=parse_options, device=device)
