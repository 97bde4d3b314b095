"""Unified local-file + http/https resource loader.

Counterpart of the reference's ``asset/resource.go:14-100``: resources are
opened from a path or URL, with relative paths resolved against the parent
resource (so scenes fetched over HTTP can reference sibling .mtl/texture
files). Remote streams are spooled to a temp file so binary loaders can seek.
"""

from __future__ import annotations

import io
import os
import tempfile
import urllib.parse
import urllib.request
from typing import Optional

from ..utils.log import get_logger

_log = get_logger("resource")


class ResourceError(IOError):
    pass


class Resource:
    """A readable scene asset, local or remote.

    ``path`` is the canonical identifier (absolute local path or full URL) and
    is used by texture/material caches as the dedupe key
    (ref: compiler.go texIndexCache keyed on res.Path()).
    """

    def __init__(self, path_or_url: str, rel_to: "Optional[Resource]" = None):
        parsed = urllib.parse.urlparse(path_or_url)
        if parsed.scheme in ("http", "https"):
            self._init_remote(path_or_url)
            return
        if parsed.scheme not in ("", "file"):
            raise ResourceError(f"unsupported scheme {parsed.scheme!r}")

        local = path_or_url[7:] if parsed.scheme == "file" else path_or_url
        if rel_to is not None and not os.path.isabs(local):
            if rel_to.is_remote:
                base = rel_to.url.rsplit("/", 1)[0] + "/"
                self._init_remote(urllib.parse.urljoin(base, local))
                return
            local = os.path.join(os.path.dirname(rel_to.path), local)
        local = os.path.abspath(local)
        if not os.path.isfile(local):
            raise ResourceError(f"no such file: {local}")
        self.path = local
        self.url = None
        self.is_remote = False
        self._local_path = local

    def _init_remote(self, url: str) -> None:
        self.path = url
        self.url = url
        self.is_remote = True
        _log.info("fetching remote resource %s", url)
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                data = resp.read()
        except Exception as exc:  # pragma: no cover - network dependent
            raise ResourceError(f"could not fetch {url}: {exc}") from exc
        fd, tmp = tempfile.mkstemp(prefix="polaris_res_")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        self._local_path = tmp

    @property
    def local_path(self) -> str:
        """Path of a seekable local copy of the resource."""
        return self._local_path

    def open_bytes(self) -> io.BufferedReader:
        return open(self._local_path, "rb")

    def read_text(self) -> str:
        with open(self._local_path, "rb") as f:
            return f.read().decode("utf-8", errors="replace")

    def close(self) -> None:
        if self.is_remote and os.path.exists(self._local_path):
            try:
                os.unlink(self._local_path)
            except OSError:
                pass

    def __repr__(self):
        return f"Resource({self.path!r})"


class StringResource(Resource):
    """In-memory resource used by tests (ref: wavefront_test.go mockResource)."""

    def __init__(self, content: str, path: str = "<memory>"):
        self.path = path
        self.url = None
        self.is_remote = False
        self._content = content
        fd, tmp = tempfile.mkstemp(prefix="polaris_str_")
        with os.fdopen(fd, "w") as f:
            f.write(content)
        self._local_path = tmp

    def read_text(self) -> str:
        return self._content
