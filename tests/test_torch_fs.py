"""The port's file systems (arrow1_tpu_torch/fs.py, fs_s3.py, fs_hdfs.py)
against the JAX package's and the protocols, on the CPU: twins of
tests/test_fs_s3.py, tests/test_fs_hdfs.py and the file-system part of
tests/test_fs_compression_validate.py.

The S3 client signs with AWS Signature Version 4 (held to the official
vector) and runs against the reference suite's in-process mock S3,
which checks every request's signature again; the WebHDFS client runs
against its mock namenode and datanode. Both servers listen on
127.0.0.1 on a free port, every client's timeout is 10 s, and each
server is shut down in a ``finally``. Datasets are read over both, the
partitioned one through an ``s3://`` URI.
"""

import hashlib
import threading
import urllib.parse
from contextlib import contextmanager
from http.server import ThreadingHTTPServer

import numpy as np
import pyarrow as pa
import pytest

from arrow1_tpu import fs as ref_fs
from arrow1_tpu.fs_s3 import sigv4_sign as ref_sigv4
from test_fs_hdfs import _MockHdfs
from test_fs_s3 import ACCESS, REGION, SECRET, _MockS3

import arrow1_tpu_torch as pt
from arrow1_tpu_torch import dataset as pds
from arrow1_tpu_torch import fs as pfs
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.fs_hdfs import WebHdfsFileSystem
from arrow1_tpu_torch.fs_s3 import NativeS3FileSystem, sigv4_sign

TIMEOUT = 10


@contextmanager
def serving(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, args=(0.05,),
                              daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT)


@pytest.fixture()
def s3fs():
    _MockS3.store = {}
    _MockS3.uploads = {}
    _MockS3.fail_signature = []
    with serving(_MockS3) as server:
        yield NativeS3FileSystem(
            access_key=ACCESS, secret_key=SECRET, region=REGION,
            endpoint_override=f"127.0.0.1:{server.server_port}",
            scheme="http", part_size=1 << 16, request_timeout=TIMEOUT)
    assert not _MockS3.fail_signature, _MockS3.fail_signature[0]


class _DirHdfs(_MockHdfs):
    """The reference's mock namenode, with LISTSTATUS telling directories
    from files (a partitioned dataset's keys are directories) and paths
    unquoted, as a namenode does ("key=value" arrives as "key%3Dvalue")."""

    def _parse(self):
        path, q = super()._parse()
        return urllib.parse.unquote(path), q

    def do_GET(self):
        path, q = self._parse()
        if q["op"] != "LISTSTATUS":
            return super().do_GET()
        base = path.rstrip("/")
        kids = {}
        for k, v in self.files.items():
            if k.startswith(base + "/"):
                head, sep, _ = k[len(base) + 1:].partition("/")
                kids[head] = ("DIRECTORY", 0) if sep else ("FILE", len(v))
        self._json({"FileStatuses": {"FileStatus": [
            {"pathSuffix": n, "type": t, "length": ln}
            for n, (t, ln) in sorted(kids.items())]}})


@pytest.fixture()
def hdfs():
    _DirHdfs.files = {}
    with serving(_DirHdfs) as server:
        yield WebHdfsFileSystem("127.0.0.1", server.server_address[1],
                                user="tester", timeout=TIMEOUT)


# ---- SigV4 ----

def test_sigv4_official_vector():
    args = ("GET", "iam.amazonaws.com", "/",
            [("Action", "ListUsers"), ("Version", "2010-05-08")],
            {"content-type":
             "application/x-www-form-urlencoded; charset=utf-8"},
            hashlib.sha256(b"").hexdigest(),
            "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG/bPxRfiCYEXAMPLEKEY",
            "us-east-1", "iam", "20150830T123600Z")
    out = sigv4_sign(*args)
    assert out["Authorization"] == (
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/iam/"
        "aws4_request, SignedHeaders=content-type;host;x-amz-date, "
        "Signature="
        "33f5dad2191de0cb4b7ab912f876876c2c4f72e2991a458f9499233c7b992438")
    assert out == ref_sigv4(*args)


@pytest.mark.parametrize("token", [None, "session"])
def test_sigv4_s3_headers_match_the_reference(token):
    args = ("PUT", "127.0.0.1:9", "/bkt/a%20b", [("partNumber", "2")],
            {"range": "bytes=0-9"}, "UNSIGNED-PAYLOAD", "AK", "SK",
            "eu-west-1", "s3", "20240101T000000Z", token)
    assert sigv4_sign(*args) == ref_sigv4(*args)


# ---- S3 against the mock ----

def test_s3_put_get_head_roundtrip(s3fs):
    with s3fs.open_output("bkt/dir/a.bin") as f:
        f.write(b"hello s3")
    info = s3fs.get_file_info("bkt/dir/a.bin")
    assert info.is_file and info.size == 8 and info.type == pfs.FileType.File
    with s3fs.open_input("bkt/dir/a.bin") as f:
        assert f.read() == b"hello s3"


def test_s3_ranged_reads_and_seek(s3fs):
    data = bytes(range(256)) * 64
    with s3fs.open_output("bkt/r.bin") as f:
        f.write(data)
    f = s3fs.open_input("bkt/r.bin")
    f.seek(1000)
    assert f.read(10) == data[1000:1010]
    f.seek(-16, 2)
    assert f.read() == data[-16:]
    f.seek(0)
    assert f.read(3) == data[:3]


def test_s3_multipart_upload(s3fs):
    blob = bytes(range(251)) * 800   # 200 KB in 64 KB parts
    with s3fs.open_output("bkt/big.bin") as f:
        for i in range(0, len(blob), 7777):
            f.write(blob[i:i + 7777])
    assert _MockS3.store[("bkt", "big.bin")] == blob
    with s3fs.open_input("bkt/big.bin") as f:
        assert f.read() == blob


def test_s3_ls_delete_and_missing(s3fs):
    for k in ("a/x.txt", "a/y.txt", "a/sub/z.txt", "top.txt", "d/1", "d/2"):
        with s3fs.open_output(f"bkt/{k}") as f:
            f.write(b"v")
    assert [(i.path, i.is_file) for i in s3fs.ls("bkt/a")] == [
        ("bkt/a/sub", False), ("bkt/a/x.txt", True), ("bkt/a/y.txt", True)]
    assert not s3fs.get_file_info("bkt").is_file
    assert not s3fs.get_file_info("bkt/a").is_file
    s3fs.delete("bkt/top.txt")
    s3fs.delete("bkt/d")
    assert ("bkt", "d/1") not in _MockS3.store
    for path in ("bkt/top.txt", "bkt/nope"):
        with pytest.raises(FileNotFoundError):
            s3fs.get_file_info(path)
    with pytest.raises(FileNotFoundError):
        s3fs.open_input("bkt/nope")
    with pytest.raises(Invalid):
        s3fs.get_file_info("/")


def test_s3_encoded_keys_sign_correctly(s3fs):
    for key in ("bkt/my file.txt", "bkt/a+b=c.bin", "bkt/ünïcode"):
        with s3fs.open_output(key) as f:
            f.write(b"enc")
        assert s3fs.get_file_info(key).size == 3
        with s3fs.open_input(key) as f:
            assert f.read() == b"enc"
        s3fs.delete(key)


# ---- WebHDFS against the mock ----

def test_webhdfs_roundtrip_listing_and_ranges(hdfs):
    for name, data in (("part-0.bin", b"hello hdfs"), ("part-1.bin",
                                                       bytes(range(100)))):
        out = hdfs.open_output(f"/data/{name}")
        out.write(data)
        out.close()
    info = hdfs.get_file_info("/data/part-0.bin")
    assert info.is_file and info.size == 10
    assert [f.path for f in hdfs.ls("/data")] == ["/data/part-0.bin",
                                                  "/data/part-1.bin"]
    assert hdfs.open_input("/data/part-0.bin").read() == b"hello hdfs"
    assert hdfs.read_range("/data/part-1.bin", 10, 5) == bytes(range(10, 15))
    hdfs.delete("/data")
    with pytest.raises(FileNotFoundError):
        hdfs.get_file_info("/data/part-0.bin")


def test_filesystem_from_uri_matches_the_reference():
    for uri in ("webhdfs://alice@127.0.0.1:9999/data/x.csv",
                "hdfs://namenode:8020/a", "hdfs://nn/b"):
        got, path = pfs.filesystem_from_uri(uri)
        want, want_path = ref_fs.filesystem_from_uri(uri)
        assert isinstance(got, WebHdfsFileSystem) and path == want_path
        assert (got.host, got.port, got.user) == (want.host, want.port,
                                                  want.user)
    for uri, cls, path in (("file:///tmp/x", pfs.LocalFileSystem, "/tmp/x"),
                           ("mock://a/b", pfs.MockFileSystem, "a/b"),
                           ("rel/path", pfs.LocalFileSystem, "rel/path")):
        got, p = pfs.filesystem_from_uri(uri)
        assert isinstance(got, cls) and p == path
    with pytest.raises(Invalid):
        pfs.filesystem_from_uri("ftp://x/y")
    s3, path = pfs.filesystem_from_uri(
        "s3://AK:S%2FK@bkt/dir?endpoint_override=127.0.0.1:9&scheme=http"
        "&region=eu-west-1")
    assert path == "bkt/dir"
    c = s3._client
    assert (c.access_key, c.secret_key, c.region, c.endpoint, c.use_ssl) \
        == ("AK", "S/K", "eu-west-1", "127.0.0.1:9", False)


# ---- local, mock and sub-tree file systems ----

def test_mock_and_subtree_match_the_reference():
    ops = [("out", "d/a.txt", b"1"), ("out", "d/e/b.txt", b"22"),
           ("out", "top", b""), ("mkdir", "empty", None)]
    results = []
    for mod in (pfs, ref_fs):
        m = mod.MockFileSystem()
        for op, path, data in ops:
            if op == "out":
                with m.open_output(path) as f:
                    f.write(data)
            else:
                m.create_dir(path)
        sub = mod.SubTreeFileSystem("d", m)
        got = ([repr(i) for i in m.ls("")], [repr(i) for i in m.ls("d")],
               repr(m.get_file_info("empty")), sub.open_input("e/b.txt")
               .read(), [repr(i) for i in sub.ls("")])
        m.delete("d")
        with pytest.raises(FileNotFoundError):
            m.get_file_info("d/a.txt")
        results.append(got)
    assert results[0] == results[1]


def test_local_file_system_and_copy_files(tmp_path):
    local = pfs.LocalFileSystem()
    local.create_dir(str(tmp_path / "src" / "sub"))
    for name, data in (("src/a.bin", b"abc"), ("src/sub/b.bin", b"x" * 5)):
        with local.open_output(str(tmp_path / name)) as f:
            f.write(data)
    infos = local.ls(str(tmp_path / "src"))
    assert [(i.path.rsplit("/", 1)[1], i.is_file, i.size) for i in infos] == \
        [("a.bin", True, 3), ("sub", False, 0)]
    mock = pfs.MockFileSystem()
    pfs.copy_files(str(tmp_path / "src"), "dst", local, mock, chunk_size=2)
    assert mock.open_input("dst/sub/b.bin").read() == b"xxxxx"
    pfs.copy_files("dst", str(tmp_path / "back"), mock, local)
    assert (tmp_path / "back" / "a.bin").read_bytes() == b"abc"
    local.delete(str(tmp_path / "back"))
    assert not (tmp_path / "back").exists()
    sel = pfs.FileSelector(str(tmp_path), recursive=True)
    assert sel.recursive and not sel.allow_not_found


# ---- datasets over S3 and WebHDFS ----

def same_tables(got, want):
    """Column names, types and values; floats by their bits (NaN equal
    to NaN), nulls where the other has nulls."""
    assert got.schema == want.schema
    for name in want.column_names:
        g, w = got[name].combine_chunks(), want[name].combine_chunks()
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if pa.types.is_floating(w.type):
            gb = g.fill_null(0).to_numpy(zero_copy_only=False).view(np.int64)
            wb = w.fill_null(0).to_numpy(zero_copy_only=False).view(np.int64)
            assert np.array_equal(gb, wb), name
        else:
            assert g.to_pylist() == w.to_pylist(), name


def _source(n=3000):
    rng = np.random.default_rng(19)
    return pa.table({
        "year": pa.array(rng.integers(2020, 2023, n), pa.int64()),
        "v": pa.array(np.where(rng.random(n) < 0.1, np.nan,
                               rng.standard_normal(n))),
        "s": pa.array(rng.choice(["a", "bb", None], n).tolist()),
    })


def test_partitioned_dataset_over_s3_uri(s3fs, tmp_path):
    src = _source()
    port = pt.interop.table_from_arrow(src, device="cpu")
    pds.write_dataset(port, str(tmp_path / "ds"), ["year"])
    pfs.copy_files(str(tmp_path / "ds"), "bkt/lake", pfs.LocalFileSystem(),
                   s3fs)
    c = s3fs._client
    uri = (f"s3://{ACCESS}:{SECRET}@bkt/lake?endpoint_override="
           f"{c.endpoint}&scheme=http&region={REGION}")
    remote = pds.dataset(uri, partitioning="hive")
    assert len(remote.fragments) == 3
    assert all(f.filesystem is not None for f in remote.fragments)
    local = pds.dataset(str(tmp_path / "ds"), partitioning="hive")
    same_tables(remote.to_table(device="cpu").to_arrow(),
                local.to_table(device="cpu").to_arrow())
    f = pt.field("year") == 2021
    assert len(remote.get_fragments(f)) == 1
    same_tables(remote.to_table(filter=f, device="cpu").to_arrow(),
                local.to_table(filter=f, device="cpu").to_arrow())


def test_dataset_over_webhdfs_uri(hdfs, tmp_path):
    """A flat dataset of two Parquet files and a partitioned one, uploaded
    through the native client and scanned through a webhdfs:// URI."""
    src = _source(400)
    port = pt.interop.table_from_arrow(src, device="cpu")
    for i in range(2):
        pt.io.write_parquet(port, str(tmp_path / f"p{i}.parquet"))
        pfs.copy_files(str(tmp_path / f"p{i}.parquet"),
                       f"/flat/part-{i}.parquet", pfs.LocalFileSystem(),
                       hdfs)
    pds.write_dataset(port, str(tmp_path / "hive"), ["year"])
    pfs.copy_files(str(tmp_path / "hive"), "/hive", pfs.LocalFileSystem(),
                   hdfs)
    base = f"webhdfs://tester@127.0.0.1:{hdfs.port}"
    flat = pds.dataset(f"{base}/flat")
    assert len(flat.fragments) == 2
    same_tables(flat.to_table(device="cpu").to_arrow(),
                pa.concat_tables([src, src]))
    hive = pds.dataset(f"{base}/hive", partitioning="hive")
    same_tables(hive.to_table(device="cpu").to_arrow(),
                pds.dataset(str(tmp_path / "hive"), partitioning="hive")
                .to_table(device="cpu").to_arrow())
    assert hive.count_rows(filter=pt.field("year") == 2020,
                           device="cpu") == int(
        (src["year"].to_numpy() == 2020).sum())
