"""File systems: local, in-memory mock, S3 and WebHDFS, with URI dispatch
(counterpart of arrow1_tpu/fs.py).

Reference: cpp/src/arrow/filesystem/ — the FileSystem API
(filesystem.h), LocalFileSystem, MockFileSystem (mockfs.h),
SubTreeFileSystem, S3FileSystem (s3fs.h) and ``FileSystemFromUri``.
``S3FileSystem`` is the native SigV4 client of ``fs_s3`` and the
``hdfs://``/``webhdfs://`` schemes reach the native WebHDFS client of
``fs_hdfs``; both speak HTTP with the standard library. The classes
backed by pyarrow.fs (``PyArrowS3FileSystem``, ``HadoopFileSystem``,
``GcsFileSystem``, ``AzureFileSystem``) import pyarrow inside
themselves, so nothing else here needs it. File systems move bytes on
the host: the dataset layer decodes them onto the device.
"""

from __future__ import annotations

import enum
import io
import os
import posixpath
import shutil
import urllib.parse
from typing import Dict, List, Optional, Tuple

from .errors import Invalid

__all__ = ["FileInfo", "FileStats", "FileType", "FileSelector",
           "FileSystem", "LocalFileSystem", "MockFileSystem",
           "SubTreeFileSystem", "S3FileSystem", "PyArrowS3FileSystem",
           "HadoopFileSystem", "FileSystemHandler", "FSSpecHandler",
           "PyFileSystem", "GcsFileSystem", "AzureFileSystem", "copy_files",
           "filesystem_from_uri", "initialize_s3", "ensure_s3_initialized",
           "finalize_s3", "ensure_s3_finalized", "resolve_s3_region",
           "S3LogLevel", "S3RetryStrategy", "AwsStandardS3RetryStrategy",
           "AwsDefaultS3RetryStrategy"]


class FileType(enum.IntEnum):
    """Reference: filesystem.h FileType."""
    NotFound = 0
    Unknown = 1
    File = 2
    Directory = 3


class FileInfo:
    """Reference: filesystem.h FileInfo (a path, its kind and size)."""

    __slots__ = ("path", "is_file", "size")

    def __init__(self, path: str, is_file: bool, size: int = 0):
        self.path = path
        self.is_file = is_file
        self.size = size

    @property
    def type(self) -> FileType:
        return FileType.File if self.is_file else FileType.Directory

    def __repr__(self):
        kind = "file" if self.is_file else "dir"
        return f"FileInfo({self.path!r}, {kind}, {self.size})"


FileStats = FileInfo   # pyarrow's older name


class FileSelector:
    """Reference: filesystem.h FileSelector (a listing's base and depth)."""

    __slots__ = ("base_dir", "recursive", "allow_not_found")

    def __init__(self, base_dir: str, allow_not_found: bool = False,
                 recursive: bool = False):
        self.base_dir = base_dir
        self.allow_not_found = allow_not_found
        self.recursive = recursive


class FileSystem:
    """The surface every file system gives: file info, listing, input and
    output streams, directories and deletion."""

    def get_file_info(self, path: str) -> FileInfo:
        raise NotImplementedError

    def ls(self, path: str) -> List[FileInfo]:
        raise NotImplementedError

    def open_input(self, path: str):
        raise NotImplementedError

    def open_output(self, path: str):
        raise NotImplementedError

    def create_dir(self, path: str):
        raise NotImplementedError

    def delete(self, path: str):
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    """Reference: filesystem/localfs.h."""

    def get_file_info(self, path):
        if os.path.isfile(path):
            return FileInfo(path, True, os.path.getsize(path))
        if os.path.isdir(path):
            return FileInfo(path, False)
        raise FileNotFoundError(path)

    def ls(self, path):
        return [self.get_file_info(os.path.join(path, name))
                for name in sorted(os.listdir(path))]

    def open_input(self, path):
        return open(path, "rb")

    def open_output(self, path):
        return open(path, "wb")

    def create_dir(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)


class _MockOutput(io.BytesIO):
    def __init__(self, fs, path):
        super().__init__()
        self._fs = fs
        self._path = path

    def close(self):
        if not self.closed:
            self._fs._files[self._path] = self.getvalue()
        super().close()


class MockFileSystem(FileSystem):
    """An in-memory tree (reference: filesystem/mockfs.h)."""

    def __init__(self):
        self._files: Dict[str, bytes] = {}
        self._dirs = {""}

    def get_file_info(self, path):
        path = path.strip("/")
        if path in self._files:
            return FileInfo(path, True, len(self._files[path]))
        if path in self._dirs or any(f.startswith(path + "/")
                                     for f in self._files):
            return FileInfo(path, False)
        raise FileNotFoundError(path)

    def ls(self, path):
        path = path.strip("/")
        prefix = path + "/" if path else ""
        seen = {}
        for f in self._files:
            if not f.startswith(prefix):
                continue
            rest = f[len(prefix):]
            full = prefix + rest.split("/", 1)[0]
            seen[full] = FileInfo(full, False) if "/" in rest else \
                FileInfo(full, True, len(self._files[f]))
        return [seen[k] for k in sorted(seen)]

    def open_input(self, path):
        path = path.strip("/")
        if path not in self._files:
            raise FileNotFoundError(path)
        return io.BytesIO(self._files[path])

    def open_output(self, path):
        path = path.strip("/")
        self._dirs.add(posixpath.dirname(path))
        return _MockOutput(self, path)

    def create_dir(self, path):
        self._dirs.add(path.strip("/"))

    def delete(self, path):
        path = path.strip("/")
        if path in self._files:
            del self._files[path]
            return
        for f in [f for f in self._files if f.startswith(path + "/")]:
            del self._files[f]
        self._dirs.discard(path)


class SubTreeFileSystem(FileSystem):
    """Every path rooted under a prefix of a base file system (reference:
    filesystem.h SubTreeFileSystem)."""

    def __init__(self, base_path: str, base_fs: FileSystem):
        self.base_path = base_path.rstrip("/")
        self.base_fs = base_fs

    def _full(self, path: str) -> str:
        return posixpath.join(self.base_path, path.lstrip("/")) \
            if path else self.base_path

    def get_file_info(self, path):
        return self.base_fs.get_file_info(self._full(path))

    def ls(self, path):
        return self.base_fs.ls(self._full(path))

    def open_input(self, path):
        return self.base_fs.open_input(self._full(path))

    def open_output(self, path):
        return self.base_fs.open_output(self._full(path))

    def create_dir(self, path):
        return self.base_fs.create_dir(self._full(path))

    def delete(self, path):
        return self.base_fs.delete(self._full(path))


def S3FileSystem(*args, use_pyarrow: bool = False, **kwargs):
    """S3 (reference: filesystem/s3fs.h): the native SigV4 client of
    ``fs_s3`` by default, the AWS-SDK-backed pyarrow one with
    ``use_pyarrow=True``."""
    if use_pyarrow:
        return PyArrowS3FileSystem(*args, **kwargs)
    from .fs_s3 import NativeS3FileSystem

    return NativeS3FileSystem(*args, **kwargs)


class _PyArrowBacked(FileSystem):
    """The FileSystem surface over a pyarrow.fs file system ``self._fs``."""

    def get_file_info(self, path):
        from pyarrow import fs as pafs

        info = self._fs.get_file_info(path)
        if info.type == pafs.FileType.NotFound:
            raise FileNotFoundError(path)
        return FileInfo(path, info.type == pafs.FileType.File,
                        info.size or 0)

    def ls(self, path):
        from pyarrow import fs as pafs

        return [FileInfo(i.path, i.type == pafs.FileType.File, i.size or 0)
                for i in self._fs.get_file_info(pafs.FileSelector(path))]

    def open_input(self, path):
        return self._fs.open_input_file(path)

    def open_output(self, path):
        return self._fs.open_output_stream(path)

    def create_dir(self, path):
        self._fs.create_dir(path)

    def delete(self, path):
        self._fs.delete_file(path)


class PyArrowS3FileSystem(_PyArrowBacked):
    """S3 through pyarrow.fs (the AWS C++ SDK the reference links)."""

    def __init__(self, **kwargs):
        from pyarrow import fs as pafs

        self._fs = pafs.S3FileSystem(**kwargs)


class HadoopFileSystem(_PyArrowBacked):
    """HDFS through pyarrow.fs and libhdfs (reference: filesystem/hdfs.h),
    for clusters that expose only the RPC protocol; ``hdfs://`` and
    ``webhdfs://`` URIs reach the native WebHDFS client first. Raises
    ``Invalid`` where the hadoop client libraries are missing."""

    def __init__(self, host: str = "default", port: int = 8020, **kwargs):
        try:
            from pyarrow import fs as pafs

            self._fs = pafs.HadoopFileSystem(host, port, **kwargs)
        except (ImportError, OSError) as e:
            raise Invalid(
                f"HDFS unavailable: libhdfs not found in this environment "
                f"({e}). Install a hadoop client to use hdfs:// paths."
            ) from e


def GcsFileSystem(*args, **kwargs):
    import pyarrow.fs as pafs

    return pafs.GcsFileSystem(*args, **kwargs)


def AzureFileSystem(*args, **kwargs):
    import pyarrow.fs as pafs

    return pafs.AzureFileSystem(*args, **kwargs)


class FileSystemHandler:
    """Duck-typed interface of a PyFileSystem handler (reference:
    python/pyarrow/fs.py FileSystemHandler)."""


class FSSpecHandler(FileSystemHandler):
    """A handler over an fsspec-style file system object."""

    def __init__(self, fs):
        self.fs = fs


class PyFileSystem(FileSystem):
    """A FileSystem backed by a Python handler (reference:
    python/pyarrow/fs.py PyFileSystem)."""

    def __init__(self, handler):
        self.handler = handler
        self._fs = getattr(handler, "fs", handler)

    def get_file_info(self, path):
        if self._fs.isfile(path):
            return FileInfo(path, True, self._fs.size(path))
        if self._fs.isdir(path):
            return FileInfo(path, False)
        raise FileNotFoundError(path)

    def ls(self, path):
        return [self.get_file_info(p) for p in sorted(self._fs.ls(path))]

    def open_input(self, path):
        return self._fs.open(path, "rb")

    def open_output(self, path):
        return self._fs.open(path, "wb")

    def create_dir(self, path):
        self._fs.makedirs(path, exist_ok=True)

    def delete(self, path):
        self._fs.rm(path, recursive=True)


def copy_files(source: str, destination: str,
               source_filesystem: Optional[FileSystem] = None,
               destination_filesystem: Optional[FileSystem] = None,
               chunk_size: int = 1 << 20, use_threads: bool = True):
    """Recursive copy between file systems (reference: filesystem.h
    CopyFiles), ``chunk_size`` bytes at a time."""
    sfs = source_filesystem or LocalFileSystem()
    dfs = destination_filesystem or LocalFileSystem()
    if sfs.get_file_info(source).is_file:
        with sfs.open_input(source) as r, dfs.open_output(destination) as w:
            while True:
                chunk = r.read(chunk_size)
                if not chunk:
                    break
                w.write(chunk)
        return
    dfs.create_dir(destination)
    for child in sfs.ls(source):
        name = posixpath.basename(child.path.rstrip("/")) or \
            os.path.basename(child.path.rstrip(os.sep))
        copy_files(child.path, posixpath.join(destination, name),
                   sfs, dfs, chunk_size, use_threads)


def filesystem_from_uri(uri: str) -> Tuple[FileSystem, str]:
    """(file system, path within it) of a URI (reference: filesystem.cc
    FileSystemFromUri). An ``s3://`` URI takes pyarrow's credentials
    (``access:secret@``) and its options ``region``, ``scheme`` and
    ``endpoint_override``. ``hdfs://`` and ``webhdfs://`` reach the native
    WebHDFS client on the namenode's HTTP port (9870 where the URI names
    an RPC port, 8020 or 9000, or none)."""
    if uri.startswith("s3://"):
        # pyarrow's S3 URI: s3://[access:secret@]bucket/path[?options]
        # with the options region, scheme and endpoint_override
        rest, _, query = uri[len("s3://"):].partition("?")
        kw = {k: v for k, v in urllib.parse.parse_qsl(query)
              if k in ("region", "scheme", "endpoint_override")}
        if "@" in rest.split("/", 1)[0]:
            cred, _, rest = rest.partition("@")
            access, _, secret = cred.partition(":")
            kw.update(access_key=urllib.parse.unquote(access),
                      secret_key=urllib.parse.unquote(secret))
        return S3FileSystem(**kw), rest
    if uri.startswith(("hdfs://", "webhdfs://")):
        from .fs_hdfs import WebHdfsFileSystem

        _, _, rest = uri.partition("://")
        hostport, _, path = rest.partition("/")
        user = None
        if "@" in hostport:
            user, _, hostport = hostport.partition("@")
        host, _, port = hostport.partition(":")
        web_port = int(port) if port and port not in ("8020", "9000") \
            else 9870
        kw = {"user": user} if user else {}
        return (WebHdfsFileSystem(host or "localhost", web_port, **kw),
                "/" + path)
    if uri.startswith("file://"):
        return LocalFileSystem(), uri[len("file://"):]
    if uri.startswith("mock://"):
        return MockFileSystem(), uri[len("mock://"):]
    if "://" in uri:
        raise Invalid(f"unsupported filesystem uri {uri!r}")
    return LocalFileSystem(), uri


# ---- pyarrow.fs's S3 module functions: the native client needs no global
# set-up, so they do nothing ----

def initialize_s3(log_level=None, num_event_loop_threads: int = 1):
    return None


def ensure_s3_initialized():
    return None


def finalize_s3():
    return None


def ensure_s3_finalized():
    return None


def resolve_s3_region(bucket: str) -> str:
    """The region a bucket lives in: the ``x-amz-bucket-region`` header of
    an anonymous HEAD on the bucket's AWS endpoint (needs the network;
    us-east-1 where the answer has none)."""
    import http.client

    conn = http.client.HTTPSConnection(f"{bucket}.s3.amazonaws.com",
                                       timeout=10)
    try:
        conn.request("HEAD", "/")
        resp = conn.getresponse()
        resp.read()
        return resp.getheader("x-amz-bucket-region") or "us-east-1"
    finally:
        conn.close()


class S3LogLevel(enum.IntEnum):
    Off = 0
    Fatal = 1
    Error = 2
    Warn = 3
    Info = 4
    Debug = 5
    Trace = 6


class S3RetryStrategy:
    def __init__(self, max_attempts: int = 3):
        self.max_attempts = max_attempts


class AwsStandardS3RetryStrategy(S3RetryStrategy):
    pass


class AwsDefaultS3RetryStrategy(S3RetryStrategy):
    pass
