"""Native S3 file system: AWS SigV4 and REST over http.client, no SDK
(counterpart of arrow1_tpu/fs_s3.py).

Reference: cpp/src/arrow/filesystem/s3fs.h / s3fs.cc (the reference links
the AWS C++ SDK; this is a from-scratch client covering the same
filesystem surface: HEAD/GET(range)/PUT/DELETE, ListObjectsV2 with
delimiter, and multipart upload for large streams).

Design notes:
- Signing is AWS Signature Version 4 (payload hash = UNSIGNED-PAYLOAD for
  streams we don't want to double-scan; exact SHA256 otherwise). The
  implementation is checked against the official SigV4 test vector in
  tests/test_torch_fs.py.
- Reads are ranged GETs behind a seekable file object with a readahead
  buffer — the dataset scanner's parquet/csv footers seek a lot.
- Writes buffer to `part_size` and switch to multipart automatically.
- `endpoint_override` targets S3-compatible stores and the test mock;
  `request_timeout` bounds each connection's socket operations.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import io
import os
import threading
import urllib.parse
from typing import Dict, List, Optional, Tuple

from .errors import Invalid
from .fs import FileInfo, FileSystem

__all__ = ["NativeS3FileSystem", "sigv4_sign"]

_UNSIGNED = "UNSIGNED-PAYLOAD"


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "" if encode_slash else "/"
    return urllib.parse.quote(s, safe=safe + "-_.~")


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_sign(method: str, host: str, path: str,
               query: List[Tuple[str, str]], headers: Dict[str, str],
               payload_hash: str, access_key: str, secret_key: str,
               region: str, service: str, amz_date: str,
               session_token: Optional[str] = None) -> Dict[str, str]:
    """Return the headers to add (Authorization, x-amz-date, ...).

    Pure function so the test suite can check it against the official
    AWS SigV4 example vector.
    """
    date_stamp = amz_date[:8]
    all_headers = dict(headers)
    all_headers["host"] = host
    all_headers["x-amz-date"] = amz_date
    if session_token:
        all_headers["x-amz-security-token"] = session_token
    if service == "s3":
        all_headers["x-amz-content-sha256"] = payload_hash

    # S3 uses the request path verbatim as the canonical URI (single
    # encoding); other services re-encode (double-encoding rule).
    canon_path = (path or "/") if service == "s3" else \
        _uri_encode(path, encode_slash=False) or "/"
    canon_q = "&".join(
        f"{_uri_encode(k)}={_uri_encode(v)}"
        for k, v in sorted(query))
    lower = {k.lower().strip(): " ".join(str(v).split())
             for k, v in all_headers.items()}
    signed = ";".join(sorted(lower))
    canon_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    canon_req = "\n".join([
        method, canon_path, canon_q,
        canon_headers, signed, payload_hash])

    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canon_req.encode()).hexdigest()])

    k = _hmac(("AWS4" + secret_key).encode(), date_stamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()

    out = {"x-amz-date": amz_date,
           "Authorization": (
               f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
               f"SignedHeaders={signed}, Signature={sig}")}
    if session_token:
        out["x-amz-security-token"] = session_token
    if service == "s3":
        out["x-amz-content-sha256"] = payload_hash
    return out


class _S3Client:
    """One bucket-agnostic REST client with pooled connections."""

    def __init__(self, access_key: Optional[str], secret_key: Optional[str],
                 session_token: Optional[str], region: str,
                 endpoint: Optional[str], use_ssl: bool,
                 timeout: float = 60.0):
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token
        self.region = region
        self.endpoint = endpoint
        self.use_ssl = use_ssl
        self.timeout = timeout
        self._local = threading.local()

    def _host(self, bucket: str) -> Tuple[str, str]:
        """-> (netloc to connect, path prefix). Path-style addressing for
        endpoint overrides (mock/minio), virtual-hosted for real AWS."""
        if self.endpoint:
            netloc = self.endpoint
            for scheme in ("http://", "https://"):
                if netloc.startswith(scheme):
                    netloc = netloc[len(scheme):]
            return netloc, f"/{bucket}"
        return f"{bucket}.s3.{self.region}.amazonaws.com", ""

    def _conn(self, netloc: str) -> http.client.HTTPConnection:
        cache = getattr(self._local, "conns", None)
        if cache is None:
            cache = self._local.conns = {}
        conn = cache.get(netloc)
        if conn is None:
            cls = (http.client.HTTPSConnection if self.use_ssl
                   else http.client.HTTPConnection)
            conn = cache[netloc] = cls(netloc, timeout=self.timeout)
        return conn

    def request(self, method: str, bucket: str, key: str,
                query: Optional[List[Tuple[str, str]]] = None,
                headers: Optional[Dict[str, str]] = None,
                body: bytes = b""
                ) -> Tuple[int, Dict[str, str], bytes]:
        netloc, prefix = self._host(bucket)
        path = prefix + "/" + _uri_encode(key, encode_slash=False)
        query = query or []
        headers = dict(headers or {})
        payload_hash = hashlib.sha256(body).hexdigest()
        if self.access_key and self.secret_key:
            amz = datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y%m%dT%H%M%SZ")
            headers.update(sigv4_sign(
                method, netloc, path, query, headers, payload_hash,
                self.access_key, self.secret_key, self.region, "s3", amz,
                self.session_token))
        qs = urllib.parse.urlencode(query)
        url = path + ("?" + qs if qs else "")
        for attempt in (0, 1):
            conn = self._conn(netloc)
            try:
                conn.request(method, url, body=body or None,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status in (301, 307):
                    hdrs = {k.lower(): v for k, v in resp.getheaders()}
                    region = hdrs.get("x-amz-bucket-region", "?")
                    raise Invalid(
                        f"s3: bucket {bucket!r} lives in region "
                        f"{region} (client configured for "
                        f"{self.region}); pass region= or set "
                        "AWS_DEFAULT_REGION")
                return resp.status, dict(resp.getheaders()), data
            except (http.client.HTTPException, ConnectionError, OSError):
                # stale pooled connection: drop and retry once
                self._local.conns.pop(netloc, None)
                try:
                    conn.close()
                except Exception:
                    pass
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def check(self, status: int, body: bytes, what: str,
              ok=(200, 204)) -> None:
        if status == 404:
            raise FileNotFoundError(what)
        if status not in ok:
            raise Invalid(f"s3: {what}: HTTP {status}: "
                          f"{body[:300].decode(errors='replace')}")


def _xml_values(xml: str, tag: str) -> List[str]:
    """All <tag>...</tag> text values (S3's XML is flat enough that a
    scanner beats pulling in a parser for the hot list path)."""
    out = []
    open_t, close_t = f"<{tag}>", f"</{tag}>"
    pos = 0
    while True:
        i = xml.find(open_t, pos)
        if i < 0:
            return out
        j = xml.find(close_t, i)
        out.append(xml[i + len(open_t):j])
        pos = j + len(close_t)


# nested <Contents>/<CommonPrefixes> blocks scan identically to leaf tags
_xml_blocks = _xml_values


class _S3InputFile(io.RawIOBase):
    """Seekable ranged-GET reader with a readahead buffer."""

    def __init__(self, client: _S3Client, bucket: str, key: str,
                 size: int, readahead: int = 1 << 20):
        self._c = client
        self._bucket = bucket
        self._key = key
        self._size = size
        self._pos = 0
        self._readahead = readahead
        self._buf = b""
        self._buf_at = 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def seek(self, off, whence=io.SEEK_SET):
        if whence == io.SEEK_SET:
            self._pos = off
        elif whence == io.SEEK_CUR:
            self._pos += off
        else:
            self._pos = self._size + off
        return self._pos

    def tell(self):
        return self._pos

    @property
    def size(self):
        return self._size

    def _fetch(self, start: int, stop: int) -> bytes:
        status, _, data = self._c.request(
            "GET", self._bucket, self._key,
            headers={"range": f"bytes={start}-{stop - 1}"})
        self._c.check(status, data, f"{self._bucket}/{self._key}",
                      ok=(200, 206))
        return data

    def read(self, n=-1):
        if n is None or n < 0:
            n = self._size - self._pos
        n = min(n, self._size - self._pos)
        if n <= 0:
            return b""
        lo, hi = self._buf_at, self._buf_at + len(self._buf)
        if not (lo <= self._pos and self._pos + n <= hi):
            fetch_to = min(self._size,
                           self._pos + max(n, self._readahead))
            self._buf = self._fetch(self._pos, fetch_to)
            self._buf_at = self._pos
        off = self._pos - self._buf_at
        out = self._buf[off:off + n]
        self._pos += len(out)
        return out

    def readinto(self, b):
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


class _S3OutputFile(io.RawIOBase):
    """Buffered writer: single PUT below part_size, multipart above."""

    def __init__(self, client: _S3Client, bucket: str, key: str,
                 part_size: int = 8 << 20):
        self._c = client
        self._bucket = bucket
        self._key = key
        self._part_size = part_size
        self._buf = bytearray()
        self._upload_id: Optional[str] = None
        self._etags: List[str] = []

    def writable(self):
        return True

    def write(self, b):
        self._buf += b
        while len(self._buf) >= self._part_size:
            self._flush_part(bytes(self._buf[:self._part_size]))
            del self._buf[:self._part_size]
        return len(b)

    def _begin_multipart(self):
        status, _, data = self._c.request(
            "POST", self._bucket, self._key, query=[("uploads", "")])
        self._c.check(status, data, f"{self._bucket}/{self._key}")
        ids = _xml_values(data.decode(), "UploadId")
        if not ids:
            raise Invalid("s3: CreateMultipartUpload returned no UploadId")
        self._upload_id = ids[0]

    def _flush_part(self, chunk: bytes):
        if self._upload_id is None:
            self._begin_multipart()
        n = len(self._etags) + 1
        status, hdrs, data = self._c.request(
            "PUT", self._bucket, self._key,
            query=[("partNumber", str(n)), ("uploadId", self._upload_id)],
            body=chunk)
        self._c.check(status, data, f"{self._bucket}/{self._key} part {n}")
        etag = {k.lower(): v for k, v in hdrs.items()}.get("etag", "")
        self._etags.append(etag)

    def close(self):
        if self.closed:
            return
        if self._upload_id is None:
            status, _, data = self._c.request(
                "PUT", self._bucket, self._key, body=bytes(self._buf))
            self._c.check(status, data, f"{self._bucket}/{self._key}")
        else:
            if self._buf:
                self._flush_part(bytes(self._buf))
                self._buf.clear()
            parts = "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber>"
                f"<ETag>{e}</ETag></Part>"
                for i, e in enumerate(self._etags))
            body = (f"<CompleteMultipartUpload>{parts}"
                    "</CompleteMultipartUpload>").encode()
            status, _, data = self._c.request(
                "POST", self._bucket, self._key,
                query=[("uploadId", self._upload_id)], body=body)
            self._c.check(status, data,
                          f"{self._bucket}/{self._key} complete")
        super().close()


class NativeS3FileSystem(FileSystem):
    """S3 surface of filesystem/s3fs.h, native wire implementation.

    Paths are "bucket/key..." like pyarrow's S3FileSystem.
    """

    def __init__(self, access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 session_token: Optional[str] = None,
                 region: Optional[str] = None,
                 endpoint_override: Optional[str] = None,
                 scheme: Optional[str] = None,
                 anonymous: bool = False,
                 part_size: int = 8 << 20,
                 request_timeout: float = 60.0):
        if not anonymous:
            access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID")
            secret_key = secret_key or os.environ.get(
                "AWS_SECRET_ACCESS_KEY")
            session_token = session_token or os.environ.get(
                "AWS_SESSION_TOKEN")
        region = (region or os.environ.get("AWS_REGION")
                  or os.environ.get("AWS_DEFAULT_REGION", "us-east-1"))
        use_ssl = (scheme or ("http" if endpoint_override
                              and not str(endpoint_override).startswith(
                                  "https") else "https")) == "https"
        self._client = _S3Client(access_key, secret_key, session_token,
                                 region, endpoint_override, use_ssl,
                                 request_timeout)
        self._part_size = part_size

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        path = path.strip("/")
        bucket, _, key = path.partition("/")
        if not bucket:
            raise Invalid(f"s3 path needs a bucket: {path!r}")
        return bucket, key

    def get_file_info(self, path: str) -> FileInfo:
        bucket, key = self._split(path)
        if not key:  # bucket root: HEAD / is HeadBucket, not an object
            return FileInfo(path.strip("/"), False)
        status, hdrs, data = self._client.request(
            "HEAD", bucket, key)
        if status == 200:
            size = int({k.lower(): v for k, v in hdrs.items()}
                       .get("content-length", 0))
            return FileInfo(path.strip("/"), True, size)
        # not an object: directory if any key lives under the prefix
        kids = self._list(bucket, key.rstrip("/") + "/" if key else "",
                          max_keys=1, follow_token=False)
        if kids[0] or kids[1] or not key:
            return FileInfo(path.strip("/"), False)
        raise FileNotFoundError(path)

    def _list(self, bucket: str, prefix: str, delimiter: str = "/",
              max_keys: int = 1000, follow_token: bool = True
              ) -> Tuple[List[Tuple[str, int]], List[str]]:
        files: List[Tuple[str, int]] = []
        dirs: List[str] = []
        token = None
        while True:
            q = [("list-type", "2"), ("prefix", prefix),
                 ("max-keys", str(max_keys))]
            if delimiter:
                q.append(("delimiter", delimiter))
            if token:
                q.append(("continuation-token", token))
            status, _, data = self._client.request("GET", bucket, "",
                                                   query=q)
            self._client.check(status, data, f"list {bucket}/{prefix}")
            xml = data.decode()
            for blk in _xml_blocks(xml, "Contents"):
                k = _xml_values(blk, "Key")[0]
                sz = int((_xml_values(blk, "Size") or ["0"])[0])
                files.append((urllib.parse.unquote(k), sz))
            for blk in _xml_blocks(xml, "CommonPrefixes"):
                dirs.append(_xml_values(blk, "Prefix")[0])
            toks = _xml_values(xml, "NextContinuationToken")
            if follow_token and \
                    _xml_values(xml, "IsTruncated") == ["true"] and toks:
                token = toks[0]
            else:
                return files, dirs

    def ls(self, path: str) -> List[FileInfo]:
        bucket, key = self._split(path)
        prefix = key.rstrip("/") + "/" if key else ""
        files, dirs = self._list(bucket, prefix)
        out = [FileInfo(f"{bucket}/{d.rstrip('/')}", False) for d in dirs]
        out += [FileInfo(f"{bucket}/{k}", True, sz) for k, sz in files
                if k != prefix]  # skip the directory marker itself
        return sorted(out, key=lambda fi: fi.path)

    def open_input(self, path: str):
        bucket, key = self._split(path)
        info = self.get_file_info(path)
        if not info.is_file:
            raise Invalid(f"s3: not a file: {path!r}")
        return io.BufferedReader(
            _S3InputFile(self._client, bucket, key, info.size))

    def open_output(self, path: str):
        bucket, key = self._split(path)
        return _S3OutputFile(self._client, bucket, key,
                             part_size=self._part_size)

    def create_dir(self, path: str):
        bucket, key = self._split(path)
        if key:
            status, _, data = self._client.request(
                "PUT", bucket, key.rstrip("/") + "/", body=b"")
            self._client.check(status, data, f"mkdir {path}")

    def delete(self, path: str):
        bucket, key = self._split(path)
        status, hdrs, _ = self._client.request("HEAD", bucket, key)
        if status == 200:
            st, _, data = self._client.request("DELETE", bucket, key)
            self._client.check(st, data, path)
            return
        files, _ = self._list(bucket, key.rstrip("/") + "/",
                              delimiter="")
        if not files:
            raise FileNotFoundError(path)
        for k, _sz in files:
            st, _, data = self._client.request("DELETE", bucket, k)
            self._client.check(st, data, f"{bucket}/{k}")
