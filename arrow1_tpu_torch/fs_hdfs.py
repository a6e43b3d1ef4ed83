"""Native HDFS file system over the WebHDFS REST API, no libhdfs or JNI
(counterpart of arrow1_tpu/fs_hdfs.py).

Reference: cpp/src/arrow/filesystem/hdfs.cc wraps libhdfs through JNI
(a JVM in the process). Hadoop clusters expose the same namenode and
datanode operations over HTTP (WebHDFS, hdfs-default.xml
dfs.webhdfs.enabled=true), so this client speaks the REST protocol
directly with http.client, as the native S3 client (fs_s3.py) does.

Operations (WebHDFS v1): GETFILESTATUS, LISTSTATUS, OPEN (with ranged
reads via offset/length), CREATE (two steps: the namenode, asked without
the data, redirects to a datanode, which takes it),
MKDIRS, DELETE. Kerberos/delegation tokens are passed through as query
params when provided; SPNEGO negotiation is out of scope.
"""

from __future__ import annotations

import http.client
import io
import json
import urllib.parse
from typing import List, Optional

from .errors import Invalid
from .fs import FileInfo, FileSystem

__all__ = ["WebHdfsFileSystem"]


class WebHdfsFileSystem(FileSystem):
    def __init__(self, host: str, port: int = 9870, user: str = "hdfs",
                 token: Optional[str] = None, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.user = user
        self.token = token
        self.timeout = timeout

    # ---------------- wire helpers ----------------------------------

    def _url(self, path: str, op: str, **params) -> str:
        if not path.startswith("/"):
            path = "/" + path
        q = {"op": op}
        if self.token:
            q["delegation"] = self.token
        else:
            q["user.name"] = self.user
        q.update({k: str(v) for k, v in params.items() if v is not None})
        return ("/webhdfs/v1" + urllib.parse.quote(path)
                + "?" + urllib.parse.urlencode(q))

    def _request(self, method: str, url: str, body=None,
                 host: Optional[str] = None, port: Optional[int] = None,
                 follow: bool = True, redirected_body: bool = False):
        """One request, a redirect followed once. With
        ``redirected_body`` the body goes only to the redirect's target:
        WebHDFS's CREATE asks the namenode without the data, then sends
        the data to the datanode it names."""
        conn = http.client.HTTPConnection(host or self.host,
                                          port or self.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, url,
                         body=None if redirected_body else body)
            resp = conn.getresponse()
            if resp.status in (301, 302, 307) and follow:
                loc = resp.getheader("Location")
                resp.read()
                u = urllib.parse.urlsplit(loc)
                return self._request(
                    method, u.path + ("?" + u.query if u.query else ""),
                    body=body, host=u.hostname, port=u.port,
                    follow=False)
            if redirected_body:
                raise Invalid(f"webhdfs {method}: the namenode answered "
                              f"{resp.status}, not a redirect to a "
                              f"datanode")
            data = resp.read()
            if resp.status >= 400:
                try:
                    msg = json.loads(data)["RemoteException"]["message"]
                except Exception:
                    msg = data[:200].decode("utf8", "replace")
                if resp.status == 404:
                    raise FileNotFoundError(msg)
                raise Invalid(f"webhdfs {method} {resp.status}: {msg}")
            return data
        finally:
            conn.close()

    # ---------------- FileSystem surface ----------------------------

    def get_file_info(self, path: str) -> FileInfo:
        data = json.loads(self._request(
            "GET", self._url(path, "GETFILESTATUS")))
        st = data["FileStatus"]
        return FileInfo(path, st["type"] == "FILE", st.get("length", 0))

    def ls(self, path: str) -> List[FileInfo]:
        data = json.loads(self._request(
            "GET", self._url(path, "LISTSTATUS")))
        out = []
        base = path.rstrip("/")
        for st in data["FileStatuses"]["FileStatus"]:
            p = f"{base}/{st['pathSuffix']}" if st["pathSuffix"] else base
            out.append(FileInfo(p, st["type"] == "FILE",
                                st.get("length", 0)))
        return out

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        """Ranged read (the dataset scanner's coalesced-fetch unit)."""
        return self._request("GET", self._url(
            path, "OPEN", offset=offset, length=length))

    def open_input(self, path: str):
        return io.BytesIO(self._request("GET", self._url(path, "OPEN")))

    def open_output(self, path: str):
        fs = self

        class _Out(io.BytesIO):
            def close(self):
                data = self.getvalue()
                fs._request("PUT", fs._url(path, "CREATE",
                                           overwrite="true"), body=data,
                            redirected_body=True)
                super().close()

        return _Out()

    def create_dir(self, path: str):
        self._request("PUT", self._url(path, "MKDIRS"))

    def delete(self, path: str):
        self._request("DELETE", self._url(path, "DELETE",
                                          recursive="true"))
