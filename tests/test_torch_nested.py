"""The nested slice of the port (list, large_list, fixed_size_list, map,
struct and both union modes; ``arrow1_tpu_torch/ops/nested.py``, the
split family and ``binary_join`` of ops/strings.py, the grouped lists,
distinct values, quantiles and pivots of ops/groupby.py) held against
the JAX package on small inputs from ``numpy.random.default_rng(15)``:
32 rows of 0-5 items, 10% null slots, null items, a null slot whose
range is not empty, sliced arrays (offset > 0).

Parity: offsets, integers, bools, strings and validity exactly, as arrow
values (type and rows); the float64 quantiles bit for bit (the same sort
and the same interpolation on both). Ingest and egress, slices and
concatenation are held against pyarrow itself (the input array is the
oracle). Where the JAX package is wrong against pyarrow.compute (ROADMAP
Queue 3), pyarrow decides (``PYARROW_DECIDES``).

The JAX answers are computed once, eagerly (nested kernels read their
sizes on the host), in a worker process (tests/test_torch_answers.py).
"""

import warnings

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import arrow1_tpu as a1t

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.compute  # noqa: F401  (the options classes)
from arrow1_tpu_torch.compute_nested import move, same_nested
from arrow1_tpu_torch.errors import A1TError
from arrow1_tpu_torch.interop import column_from_arrow
from test_torch_answers import answers_of
from test_torch_registry_sweep import as_arrow, assert_same

ROWS = 32
_rng = np.random.default_rng(15)


def _lists(make_item, rows=ROWS, extra=3, item_nulls=0.05):
    """``rows + extra`` lists of 0-5 items, 10% null slots, one null slot
    with a non-empty range, sliced to ``rows`` at offset ``extra``."""
    n = rows + extra
    lengths = _rng.integers(0, 6, n)
    null = _rng.random(n) < 0.10
    null[extra + 4] = True
    lengths[extra + 4] = 3   # a null slot's range holds items
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    items = [make_item() for _ in range(int(offsets[-1]))]
    items = [None if _rng.random() < item_nulls else v for v in items]
    arr = pa.ListArray.from_arrays(pa.array(offsets), pa.array(items),
                                   mask=pa.array(null))
    return arr.slice(extra)


def _ints():
    return int(_rng.integers(-50, 50))


_KEYS = ["a", "b", "c", "d"]
_WORDS = ["AIR", "REG AIR", "Customer#000000007", "a#b##c", " lead",
          "trail ", "x  y", "", "é ü", "one"]


def _map(rows=ROWS):
    """A map<string, int64> of 0-4 entries (keys from a pool of four,
    repeats kept), 10% null slots, one null slot with a non-empty range."""
    lengths = _rng.integers(0, 5, rows)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    total = int(offsets[-1])
    null = _rng.random(rows) < 0.10
    null[np.flatnonzero(lengths)[0]] = True
    keys = pa.array([_KEYS[i] for i in _rng.integers(0, 4, total)])
    items = pa.array(_rng.integers(0, 100, total))
    return pa.MapArray.from_arrays(pa.array(offsets), keys, items,
                                   mask=pa.array(null))


def _fsl(rows=ROWS, extra=2):
    values = pa.array(_rng.integers(-9, 9, (rows + extra) * 3))
    null = _rng.random(rows + extra) < 0.10
    return pa.FixedSizeListArray.from_arrays(
        values, 3, mask=pa.array(null)).slice(extra)


def _struct(rows=ROWS, extra=1):
    n = rows + extra
    a = pa.array(_rng.integers(0, 9, n), mask=_rng.random(n) < 0.1)
    b = pa.array([_WORDS[i] for i in _rng.integers(0, len(_WORDS), n)])
    return pa.StructArray.from_arrays(
        [a, b], names=["a", "b"], mask=pa.array(_rng.random(n) < 0.1)
    ).slice(extra)


def _unions(rows=ROWS):
    ids = pa.array(_rng.integers(0, 2, rows).astype(np.int8))
    ints = pa.array(_rng.integers(0, 9, rows), mask=_rng.random(rows) < 0.2)
    strs = pa.array([_WORDS[i] for i in _rng.integers(0, 4, rows)],
                    mask=_rng.random(rows) < 0.2)
    sparse = pa.UnionArray.from_sparse(ids, [ints, strs], ["i", "s"],
                                       [0, 1])
    counts = np.bincount(np.asarray(ids), minlength=2)
    offs = np.zeros(rows, np.int32)
    for code in (0, 1):
        offs[np.asarray(ids) == code] = np.arange(counts[code])
    dense = pa.UnionArray.from_dense(
        ids, pa.array(offs), [ints.slice(0, counts[0]),
                              strs.slice(0, counts[1])], ["i", "s"], [0, 1])
    return sparse, dense


_SPARSE, _DENSE = _unions()
_GROUPS = 8
INPUTS = {
    "l": _lists(_ints),
    "lf": _lists(lambda: float(_rng.standard_normal())),
    "ls": _lists(lambda: _WORDS[_rng.integers(0, len(_WORDS))]),
    "ll": pa.array(_lists(_ints).to_pylist(), pa.large_list(pa.int64())),
    "le": pa.array([None if _rng.random() < 0.1 else
                    [int(x) for x in _rng.integers(0, 9, 2 + k % 3)]
                    for k in range(ROWS)]),
    "nl": pa.array([None if _rng.random() < 0.1 else
                    [None if _rng.random() < 0.1 else
                     [int(x) for x in _rng.integers(0, 9, j)]
                     for j in _rng.integers(0, 3, _rng.integers(0, 4))]
                    for _ in range(ROWS)]),
    "fsl": _fsl(),
    "m": _map(),
    "st": _struct(),
    "su": _SPARSE,
    "du": _DENSE,
    "v": pa.array(_rng.integers(-20, 20, ROWS), mask=_rng.random(ROWS) < .1),
    "f": pa.array(_rng.standard_normal(ROWS), mask=_rng.random(ROWS) < .1),
    "g": pa.array(_rng.integers(0, _GROUPS, ROWS)),
    "k": pa.array([["A", "N", "R", "X"][i] for i in
                   _rng.integers(0, 4, ROWS)]),
    "s": pa.array([_WORDS[i] for i in _rng.integers(0, len(_WORDS), ROWS)],
                  mask=_rng.random(ROWS) < 0.1),
    "sep": pa.array([["-", "", "::"][i] for i in _rng.integers(0, 3, ROWS)],
                    mask=_rng.random(ROWS) < 0.1),
    "mask": pa.array((_rng.random(ROWS) < 0.6).tolist(),
                     mask=_rng.random(ROWS) < 0.1),
    "idx": pa.array(_rng.integers(0, ROWS, 20), mask=_rng.random(20) < 0.1),
}
# a pivot: every (group, key) at most once among the non-null values
_PAIRS = [(g, k) for g in range(6) for k in ("A", "N", "R")]
_PICK = _rng.permutation(len(_PAIRS))[:14]
INPUTS["pg"] = pa.array([_PAIRS[i][0] for i in _PICK])
INPUTS["pk"] = pa.array([_PAIRS[i][1] for i in _PICK])
INPUTS["pv"] = pa.array(_rng.integers(0, 99, len(_PICK)),
                        mask=_rng.random(len(_PICK)) < 0.15)
INPUTS["pk1"] = pa.array(["R", "A", "Z", "N"])
INPUTS["pv1"] = pa.array([1.5, None, 2.5, 3.5])
INPUTS["pk_dup"] = pa.array(["A", "A", "N"])
INPUTS["pv_dup"] = pa.array([1, 2, 3])


def S(value):
    """A scalar argument."""
    return ("scalar", value)


# id -> (function, arguments, options)
CASES = {}
for _col in ("l", "ll", "fsl", "m", "nl", "le"):
    CASES[f"list_value_length-{_col}"] = ("list_value_length", [_col], {})
    CASES[f"list_flatten-{_col}"] = ("list_flatten", [_col], {})
for _col in ("l", "ll", "fsl", "nl"):
    CASES[f"list_parent_indices-{_col}"] = ("list_parent_indices", [_col],
                                            {})
CASES["list_flatten-nl-recursive"] = ("list_flatten", ["nl"],
                                      {"recursive": True})
for _i in (0, 1):
    CASES[f"list_element-le-{_i}"] = ("list_element", ["le"], {"index": _i})
CASES["list_element-fsl-2"] = ("list_element", ["fsl"], {"index": 2})
CASES["list_element-l-raises"] = ("list_element", ["l"], {"index": 0})
for _col in ("l", "lf", "ls", "nl", "fsl"):
    CASES[f"list_slice-{_col}-0-2"] = ("list_slice", [_col],
                                       {"start": 0, "stop": 2})
CASES["list_slice-l-1-end"] = ("list_slice", ["l"], {"start": 1})
CASES["list_slice-l-step"] = ("list_slice", ["l"], {"start": 0, "stop": 5,
                                                    "step": 2})
CASES["list_slice-fsl-pad"] = ("list_slice", ["fsl"], {"start": 1,
                                                       "stop": 5})
CASES["list_slice-ll"] = ("list_slice", ["ll"], {"start": 1, "stop": 3})
CASES["make_struct-v-f"] = ("make_struct", ["v", "f"],
                            {"field_names": ("v", "f")})
CASES["make_struct-default-names"] = ("make_struct", ["v", "l"], {})
CASES["project-v-s"] = ("project", ["v", "s"], {"field_names": ("x", "y")})
CASES["struct_field-st-a"] = ("struct_field", ["st"], {"field": "a"})
CASES["struct_field-st-1"] = ("struct_field", ["st"], {"field": 1})
for _occ in ("first", "last", "all"):
    for _key in ("a", "zz"):
        CASES[f"map_lookup-{_occ}-{_key}"] = (
            "map_lookup", ["m"], {"query_key": _key, "occurrence": _occ})
CASES["split_pattern-hash"] = ("split_pattern", ["s"], {"pattern": "#"})
CASES["split_pattern-max"] = ("split_pattern", ["s"],
                              {"pattern": "#", "max_splits": 1})
CASES["split_pattern-reverse"] = ("split_pattern", ["s"], {
    "pattern": "#", "max_splits": 1, "reverse": True})
CASES["split_pattern_regex"] = ("split_pattern_regex", ["s"],
                                {"pattern": "[# ]+"})
CASES["ascii_split_whitespace"] = ("ascii_split_whitespace", ["s"], {})
CASES["ascii_split_whitespace-max"] = ("ascii_split_whitespace", ["s"],
                                       {"max_splits": 1})
CASES["utf8_split_whitespace"] = ("utf8_split_whitespace", ["s"], {})
CASES["utf8_split_whitespace-reverse"] = ("utf8_split_whitespace", ["s"], {
    "max_splits": 1, "reverse": True})
CASES["binary_join-scalar"] = ("binary_join", ["ls", S("-")], {})
CASES["binary_join-column"] = ("binary_join", ["ls", "sep"], {})
CASES["binary_join-split"] = ("binary_join", ["split:s", S("#")], {})
for _vals in ("v", "f", "s", "l"):
    CASES[f"hash_list-{_vals}"] = ("hash_list", [_vals, "g"], {})
for _vals in ("v", "s"):
    CASES[f"hash_distinct-{_vals}"] = ("hash_distinct", [_vals, "g"], {})
CASES["hash_tdigest-f"] = ("hash_tdigest", ["f", "g"], {"q": (0.5, 0.9)})
CASES["hash_tdigest-v"] = ("hash_tdigest", ["v", "g"], {})
CASES["pivot_wider"] = ("pivot_wider", ["pk1", "pv1"],
                        {"key_names": ("A", "N", "R")})
CASES["pivot_wider-dup"] = ("pivot_wider", ["pk_dup", "pv_dup"],
                            {"key_names": ("A", "N")})
CASES["hash_pivot_wider"] = ("hash_pivot_wider", ["pk", "pv", "pg"],
                             {"key_names": ("A", "N", "R", "Z")})
CASES["extract_regex"] = ("extract_regex", ["s"],
                          {"pattern": "(?P<w>[A-Za-z]+)(?P<d>#?[0-9]*)"})
CASES["extract_regex_span"] = ("extract_regex_span", ["s"],
                               {"pattern": "(?P<w>[A-Za-z]+)(?P<d>#[0-9]+)?"})
for _col in ("l", "fsl", "m", "st", "su", "du", "nl"):
    CASES[f"take-{_col}"] = ("take", [_col, "idx"], {})
    CASES[f"filter-{_col}"] = ("filter", [_col, "mask"], {})
CASES["filter-l-emit_null"] = ("filter", ["l", "mask"],
                               {"null_selection_behavior": "emit_null"})
CASES["drop_null-l"] = ("drop_null", ["l"], {})

# the 18 names of ROADMAP Queue 1 item 9
NAMES = ("list_value_length", "list_flatten", "list_parent_indices",
         "list_element", "list_slice", "make_struct", "struct_field",
         "map_lookup", "split_pattern", "split_pattern_regex",
         "ascii_split_whitespace", "utf8_split_whitespace", "binary_join",
         "hash_list", "hash_distinct", "hash_tdigest", "pivot_wider",
         "hash_pivot_wider")

# where the JAX package is wrong against pyarrow (ROADMAP Queue 3): case
# -> what it does; the port is held to pyarrow's answer
PYARROW_DECIDES = {
    "list_value_length-ll": "int32 for a large_list (pyarrow: int64)",
    "list_slice-fsl-0-2": "a fixed_size_list slice gives a list",
    "list_slice-fsl-pad": "a fixed_size_list slice gives a list, unpadded",
    "list_slice-ll": "its large_list comes back as a list",
    "filter-m": "a map's null slot keeps its entries: they leak into the "
                "next slot of a filter",
    "filter-l-emit_null": "an emitted null slot's range leaks into the "
                          "next slot",
    "list_flatten-m": "a map's null slot keeps its entries in the flat "
                      "child",
    "take-su": "raises (a union is not taken)",
    "take-du": "raises (a union is not taken)",
    "filter-su": "raises (a union is not filtered)",
    "filter-du": "raises (a union is not filtered)",
    "hash_list-l": "raises (a list of lists)",
    "hash_tdigest-f": "a group with no valid value reads past its segment",
    "hash_tdigest-v": "a group with no valid value reads past its segment",
}


def _arg(pkg, inp, token):
    if isinstance(token, tuple):
        return pkg.scalar(token[1])
    if token.startswith("split:"):
        return pkg.call_function("split_pattern", [inp[token[6:]]],
                                 pattern="#")
    return inp[token]


def _call(pkg, inp, case):
    name, tokens, options = CASES[case]
    return pkg.call_function(name, [_arg(pkg, inp, t) for t in tokens],
                             **options)


def _group_by(pkg, rb):
    return pkg.group_by(rb, ["g"], [("v", "list"), ("v", "distinct"),
                                    ("s", "list")])


def _rows_by(batch, key):
    rows = as_arrow(batch).to_pylist()
    return sorted(rows, key=lambda r: repr(r[key]))


_QUERY_TABLE = pa.table({"l": INPUTS["l"], "v": INPUTS["v"],
                         "st": INPUTS["st"]})


def _query(pkg, table):
    return (pkg.query(table).filter(pkg.field("v") > -10)
            .select(["l", "v", "st"]).order_by([("v", "descending")])
            .to_table())


def _reference_entry(col):
    """A JAX package column as ``from_reference_arrays`` takes it: numpy
    buffers and the port's type."""
    from arrow1_tpu.column import ListColumn, StructColumn, UnionColumn
    from arrow1_tpu.table import RecordBatch

    def arr(x):
        return None if x is None else np.asarray(x)

    if isinstance(col, ListColumn):
        values = [_reference_entry(c) for c in col.values.columns] \
            if isinstance(col.values, RecordBatch) else \
            _reference_entry(col.values)
        return {"type": col.dtype.kind, "arrow": col.to_arrow().type,
                "offsets": arr(col.offsets), "values": values,
                "validity": arr(col.validity)}
    if isinstance(col, StructColumn):
        return {"type": "struct", "arrow": col.to_arrow().type,
                "children": [_reference_entry(c) for c in col.children],
                "validity": arr(col.validity)}
    if isinstance(col, UnionColumn):
        return {"type": "union", "arrow": col.to_arrow().type,
                "type_ids": arr(col.type_ids), "offsets": arr(col.offsets),
                "children": [_reference_entry(c) for c in col.children]}
    return (arr(col.data), arr(col.validity),
            None if col.dictionary is None else
            np.asarray(col.dictionary.values))


def reference_answers(part=None) -> dict:
    """The JAX package's answer to every case it decides, computed
    eagerly, as arrow values (or the class of what it raised): a third of
    the cases in each of parts 0, 1 and 2, the group_by, the query and
    the columns' buffers in part 2; all when no part is named. The parts
    run in worker processes of their own, at once."""
    import arrow1_tpu.compute  # noqa: F401  (the options classes)

    inputs = {k: a1t.column(a) for k, a in INPUTS.items()}
    answers = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, case in enumerate(CASES):
            if case in PYARROW_DECIDES or part not in (None, i % 3):
                continue
            try:
                answers[case] = as_arrow(_call(a1t, inputs, case))
            except Exception as e:   # noqa: BLE001 (the class is kept)
                answers[case] = type(e)
        if part not in (None, 2):
            return answers
        rb = a1t.record_batch(pa.record_batch({
            k: INPUTS[k] for k in ("g", "v", "s")}))
        answers["group_by"] = _rows_by(_group_by(a1t, rb), "g")
        answers["query"] = as_arrow(_query(a1t, a1t.table(_QUERY_TABLE)))
        for key in ("l", "fsl", "nl", "st", "du", "su", "ls"):
            answers[f"entry-{key}"] = _reference_entry(inputs[key])
    return answers


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


def _port_inputs():
    return {k: column_from_arrow(a, device="cpu") for k, a in INPUTS.items()}


def _port(case):
    try:
        return _call(pt, _port_inputs(), case)
    except (A1TError, TypeError, ValueError) as e:
        return type(e)


def _group_rows(values, gids):
    """Each group id's values, in row order (groups 0..max)."""
    out = [[] for _ in range(max(gids) + 1)]
    for v, g in zip(values, gids):
        out[g].append(v)
    return out


def _quantiles(values, gids, qs):
    """Exact quantiles by linear interpolation, as both packages compute
    them (pyarrow's t-digest approximates them): at the position counted
    from the group's first row among all rows sorted by group, as they
    count it; None for a group of no valid value, as pyarrow gives."""
    out = []
    start = 0
    for vals in _group_rows(values, gids):
        xs = np.sort(np.array([v for v in vals if v is not None],
                              dtype=np.float64))
        row = []
        for q in qs:
            if not len(xs):
                row.append(None)
                continue
            pos = np.float64(start) + np.float64(len(xs) - 1) * q
            lo, hi = int(np.floor(pos)) - start, int(np.ceil(pos)) - start
            frac = pos - np.floor(pos)
            row.append(float(xs[lo] * (1 - frac) + xs[hi] * frac))
        out.append(row)
        start += len(vals)
    return pa.array(out, pa.list_(pa.float64()))


def _pyarrow(case):
    """pyarrow's answer (or its rows, built from the inputs' rows where
    pyarrow has no such call)."""
    name, tokens, options = CASES[case]
    args = [INPUTS[t] if isinstance(t, str) else pa.scalar(t[1])
            for t in tokens]
    if case == "list_flatten-m":   # pyarrow flattens no map
        return pa.RecordBatch.from_pylist(
            [{"key": k, "value": v} for slot in args[0].to_pylist()
             if slot for k, v in slot], schema=pa.schema(
                [("key", pa.string()), ("value", pa.int64())]))
    if name == "hash_list":   # no direct call of a hash aggregate
        return pa.array(_group_rows(args[0].to_pylist(),
                                    args[1].to_pylist()),
                        pa.list_(args[0].type))
    if name == "hash_tdigest":
        return _quantiles(args[0].to_pylist(), args[1].to_pylist(),
                          options.get("q", (0.5,)))
    if name == "list_slice":
        return pc.list_slice(*args, **options)
    if name == "filter":
        return pc.filter(*args, **options)
    return pc.call_function(name, args)


def test_the_slice_covers_its_names():
    assert {CASES[c][0] for c in CASES} >= set(NAMES)
    assert set(NAMES) <= set(pt.list_functions())


@pytest.mark.parametrize("case", list(CASES))
def test_nested_matches_the_reference(case, jax_results):
    got = _port(case)
    if case in PYARROW_DECIDES:
        want = _pyarrow(case)
    else:
        want = jax_results[case]
    if isinstance(want, type):
        assert isinstance(got, type), (case, "should raise", got)
        return
    assert not isinstance(got, type), (case, got, want)
    assert_same(got, want, case, ulps=0)


@pytest.mark.parametrize("key", ["l", "lf", "ls", "ll", "le", "nl", "fsl",
                                 "m", "st", "su", "du"])
def test_ingest_and_egress_round_trip(key):
    """Each nested array (sliced, with null slots, a null slot's
    non-empty range) back out as the same arrow type and rows; a slice
    of the column equals the array's slice; two columns concatenate as
    pyarrow concatenates."""
    arr = INPUTS[key]
    col = column_from_arrow(arr, device="cpu")
    out = col.to_arrow()
    assert out.type == arr.type and out.to_pylist() == arr.to_pylist()
    assert pt.dtypes.to_arrow(col.dtype) == arr.type
    part = col.slice(5, 9)
    assert part.to_pylist() == arr.slice(5, 9).to_pylist()
    both = pt.concat_columns([col, part])
    assert both.to_arrow().type == arr.type
    assert both.to_pylist() == pa.concat_arrays(
        [arr, arr.slice(5, 9)]).to_pylist()
    moved = move(col, "cpu")
    assert same_nested(moved, col) is None
    chunked = pt.interop.column_from_arrow(
        pa.chunked_array([arr.slice(0, 7), arr.slice(7)]), device="cpu")
    assert chunked.to_pylist() == arr.to_pylist()


def test_reference_faults_of_ingest():
    """The JAX package reads a sliced map's keys and items and a sliced
    union's type codes from the unsliced buffers (ROADMAP Queue 3); the
    port's ingest gives pyarrow's rows."""
    for key in ("m", "su", "du"):
        arr = INPUTS[key].slice(3)
        assert column_from_arrow(arr, device="cpu").to_pylist() == \
            arr.to_pylist(), key
        assert a1t.column(arr).to_pylist() != arr.to_pylist(), key


def test_list_slice_refuses_what_pyarrow_refuses():
    """A start past the stop, or below 0, raises in pyarrow and the port;
    the JAX package gives empty lists (ROADMAP Queue 3)."""
    col = column_from_arrow(INPUTS["l"], device="cpu")
    for start, stop in ((3, 1), (-1, 2)):
        with pytest.raises(pa.ArrowInvalid):
            pc.list_slice(INPUTS["l"], start, stop)
        with pytest.raises(A1TError):
            pt.call_function("list_slice", [col], start=start, stop=stop)


@pytest.mark.parametrize("key", ["l", "fsl", "nl", "st", "du", "su", "ls"])
def test_reference_columns_carry_across(key, jax_results):
    """``from_reference_arrays`` takes the JAX package's nested columns as
    numpy buffers: the port then holds the same rows as its own ingest."""
    entry = _port_entry(jax_results[f"entry-{key}"])
    rb = pt.from_reference_arrays(["c"], [entry], "cpu")
    got = rb["c"]
    assert got.to_arrow().type == INPUTS[key].type
    assert got.to_pylist() == INPUTS[key].to_pylist()
    assert same_nested(got, column_from_arrow(INPUTS[key],
                                              device="cpu")) is None


def _port_entry(entry):
    if not isinstance(entry, dict):
        return entry
    out = dict(entry)
    out["type"] = pt.dtypes.from_arrow(out.pop("arrow"))
    for k in ("values", "children"):
        if k in out:
            out[k] = [_port_entry(c) for c in out[k]] \
                if isinstance(out[k], list) else _port_entry(out[k])
    return out


def test_grouped_lists_in_group_by(jax_results):
    rb = pt.record_batch(pa.record_batch({k: INPUTS[k]
                                          for k in ("g", "v", "s")}),
                         device="cpu")
    assert _rows_by(_group_by(pt, rb), "g") == jax_results["group_by"]


def test_query_carries_nested_columns(jax_results):
    """filter, select and order_by over a Table with a list and a struct
    column, as the JAX package's query layer carries them."""
    got = _query(pt, pt.interop.table_from_arrow(_QUERY_TABLE,
                                                 device="cpu"))
    assert_same(got, jax_results["query"], "query")
    assert got.to_arrow().to_pylist() == _QUERY_TABLE.filter(
        pc.greater(_QUERY_TABLE["v"], -10)).sort_by(
            [("v", "descending")]).to_pylist()


def test_struct_batches_and_flatten():
    """RecordBatch.to_struct_array and back; Table.flatten as pyarrow's
    (a null struct slot nulls its fields)."""
    table = pa.table({"st": INPUTS["st"], "v": INPUTS["v"]})
    t = pt.interop.table_from_arrow(table, device="cpu")
    assert t.flatten().to_arrow().to_pylist() == \
        table.flatten().to_pylist()
    rb = t.batches[0]
    s = rb.to_struct_array()
    assert s.to_pylist() == pa.StructArray.from_arrays(
        [table["st"].combine_chunks(), table["v"].combine_chunks()],
        names=["st", "v"]).to_pylist()
    assert pt.RecordBatch.from_struct_array(s).names == rb.names


def test_hash_tdigest_of_an_all_null_group_is_null():
    """pyarrow's quantiles of a group with no valid value are nulls; the
    JAX package reads past its segment (ROADMAP Queue 3)."""
    f = pa.array([1.0, None, 4.0, None, 3.0])
    g = pa.array([0, 1, 0, 1, 2])
    got = pt.call_function("hash_tdigest", [
        column_from_arrow(f, device="cpu"),
        column_from_arrow(g, device="cpu")], q=(0.5, 0.9))
    want = pa.table({"g": g, "f": f}).group_by("g", use_threads=False) \
        .aggregate([("f", "tdigest", pc.TDigestOptions(q=[0.5, 0.9]))])
    assert want["f_tdigest"].to_pylist()[1] == [None, None]
    assert got.to_pylist() == [[2.5, 3.7], [None, None], [3.0, 3.0]]


def test_filter_moves_nested_columns_through_k2(monkeypatch):
    """A batch with a list column filters in one compaction call: the
    flat columns and the row numbers ride it, the list column is
    gathered by the kept rows."""
    from arrow1_tpu_torch.ops import selection

    calls = []
    real = selection.compact

    def counting(mask, streams, *a, **k):
        calls.append(len(streams))
        return real(mask, streams, *a, **k)

    monkeypatch.setattr(selection, "compact", counting)
    rb = pt.record_batch(pa.record_batch({"l": INPUTS["l"],
                                          "v": INPUTS["v"]}), device="cpu")
    keep = pt.call_function("greater", [pt.call_function(
        "list_value_length", [rb["l"]]), pt.scalar(2, pt.int32)])
    keep = pt.call_function("fill_null", [keep, pt.scalar(False)])
    out = pt.filter(rb, keep)
    assert calls == [3]   # v's data and validity, the row numbers
    want = pa.record_batch({"l": INPUTS["l"], "v": INPUTS["v"]}).filter(
        pc.fill_null(pc.greater(pc.list_value_length(INPUTS["l"]), 2),
                     False))
    assert out.to_arrow().to_pylist() == want.to_pylist()


def test_nested_entry_points_want_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        column_from_arrow(INPUTS["l"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.fixed_size_list_column(np.zeros((3, 2)))
    assert pt.fixed_size_list_column(np.zeros((3, 2)), device="cpu") \
        .to_2d().shape == (3, 2)
