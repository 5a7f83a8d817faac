"""URI-addressed storage for the pipeline trainer's stage shards, the
train executor's checkpoints, the node manager's object spilling and the
GCS's external store.

Counterpart of ``ray_tpu/util/storage.py`` (without its directory
upload): plain paths and ``file://`` map to the local
filesystem through the standard library; any other scheme (gs://, s3://,
memory://, ...) resolves through fsspec, imported only when such a URI
is used.
"""

from __future__ import annotations

import os
from typing import List, Tuple


def _split(uri: str) -> Tuple[str, str]:
    """-> (scheme, path); plain paths get scheme ''. file: URIs normalize
    to plain absolute paths in both RFC-8089 forms, file:///x and
    file:/x."""
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        if scheme == "file":
            return "", "/" + rest.lstrip("/")
        return scheme, uri
    if uri.startswith("file:"):
        return "", "/" + uri[len("file:"):].lstrip("/")
    return "", uri



def validate_root(uri: str, what: str = "storage") -> str:
    """Validate a spill/checkpoint/persist root URI: local paths must be
    absolute (a relative root silently writes into whatever CWD the
    daemon happens to have). Returns the URI unchanged."""
    scheme, path = _split(uri)
    if not scheme and not os.path.isabs(path):
        raise ValueError(
            f"{what} root {uri!r} resolves to the relative local path "
            f"{path!r}; use an absolute path or a scheme:// URI")
    return uri

def is_remote(uri: str) -> bool:
    return _split(uri)[0] != ""


def _fs(uri: str):
    import fsspec
    return fsspec.core.url_to_fs(uri)   # (fs, path)


def join(uri: str, *parts: str) -> str:
    if is_remote(uri):
        return "/".join([uri.rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(_split(uri)[1], *parts)


def makedirs(uri: str) -> None:
    scheme, path = _split(uri)
    if not scheme:
        os.makedirs(path, exist_ok=True)
        return
    fs, p = _fs(uri)
    fs.makedirs(p, exist_ok=True)


def write_bytes(uri: str, data: bytes) -> None:
    """Write atomically on a local path (a temporary file, then rename)."""
    scheme, path = _split(uri)
    if not scheme:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return
    fs, p = _fs(uri)
    parent = p.rsplit("/", 1)[0]
    if parent:
        fs.makedirs(parent, exist_ok=True)
    with fs.open(p, "wb") as f:
        f.write(data)


def read_bytes(uri: str) -> bytes:
    scheme, path = _split(uri)
    if not scheme:
        with open(path, "rb") as f:
            return f.read()
    fs, p = _fs(uri)
    with fs.open(p, "rb") as f:
        return f.read()


def exists(uri: str) -> bool:
    scheme, path = _split(uri)
    if not scheme:
        return os.path.exists(path)
    fs, p = _fs(uri)
    return fs.exists(p)


def delete(uri: str) -> bool:
    scheme, path = _split(uri)
    try:
        if not scheme:
            os.unlink(path)
        else:
            fs, p = _fs(uri)
            fs.rm(p)
        return True
    except (OSError, FileNotFoundError):
        return False


def delete_dir(uri: str) -> bool:
    scheme, path = _split(uri)
    try:
        if not scheme:
            import shutil
            shutil.rmtree(path, ignore_errors=True)
        else:
            fs, p = _fs(uri)
            fs.rm(p, recursive=True)
        return True
    except (OSError, FileNotFoundError):
        return False


def listdir(uri: str) -> List[str]:
    """Child names (not full paths); empty list if missing."""
    scheme, path = _split(uri)
    try:
        if not scheme:
            return sorted(os.listdir(path))
        fs, p = _fs(uri)
        return sorted(x.rstrip("/").rsplit("/", 1)[-1]
                      for x in fs.ls(p, detail=False))
    except (OSError, FileNotFoundError):
        return []


def download_dir(uri: str, local_dir: str) -> None:
    """Recursively copy a URI directory tree to a local directory."""
    scheme, path = _split(uri)
    os.makedirs(local_dir, exist_ok=True)
    if not scheme:
        import shutil
        for name in os.listdir(path):
            src = os.path.join(path, name)
            dst = os.path.join(local_dir, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        return
    fs, p = _fs(uri)
    base = p.rstrip("/")
    for info in fs.find(base):
        rel = info[len(base):].lstrip("/")
        dst = os.path.join(local_dir, *rel.split("/"))
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        with fs.open(info, "rb") as f:
            data = f.read()
        with open(dst, "wb") as f:
            f.write(data)
