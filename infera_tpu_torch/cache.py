"""Remote model fetch + disk cache.

Behavioral port of upstream infera/src/http.rs (N4 in SURVEY.md §2.1) —
kept verbatim per SURVEY.md §5 "keep the reference's retry/ETag semantics for
model fetch":

- cache key = SHA-256(url) hex → ``<hex>.onnx`` with ``<hex>.etag`` sidecar
  (http.rs:185-189)
- fast path: cached file with no etag sidecar → immediate hit + atime touch
  (http.rs:198-207)
- etag present → conditional GET ``If-None-Match``; 304 → touch + reuse
  (http.rs:236-240)
- retry loop: attempt 1..=N with delay = retry_delay_ms × attempt
  (http.rs:226-285)
- LRU eviction by file atime before committing a new file (http.rs:98-120)
- crash-safe partial downloads: ``.onnx.part`` temp + atomic rename, guard
  deletes the temp on any failure path (http.rs:15-43, :252-253)
- ``clear_cache`` deletes all files/dirs in the cache dir (http.rs:124-141)

Per-host cache: under multi-host execution each process keeps its own cache
directory (SURVEY.md §7.1 registry replication).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path

from . import log
from .config import get_config
from .errors import CacheDirError, HttpRequestError, InferaError, IoError


def cache_dir() -> Path:
    return get_config().cache_dir


def _touch(path: Path) -> None:
    if path.exists():
        try:
            now = time.time()
            os.utime(path, (now, os.stat(path).st_mtime))
        except OSError as e:
            raise IoError(str(e))


def _cached_files_by_atime(directory: Path) -> list:
    """[(path, atime, size)] for *.onnx files, oldest-accessed first."""
    if not directory.exists():
        return []
    files = []
    for p in directory.iterdir():
        if p.is_file() and p.suffix == ".onnx":
            try:
                st = p.stat()
            except OSError:
                continue
            files.append((p, st.st_atime, st.st_size))
    files.sort(key=lambda t: t[1])
    return files


def get_cache_size() -> int:
    return sum(size for _, _, size in _cached_files_by_atime(cache_dir()))


def evict_cache_if_needed(required_space: int) -> None:
    """LRU eviction until current + required <= limit (http.rs:98-120)."""
    limit = get_config().cache_size_limit
    current = get_cache_size()
    if current + required_space <= limit:
        return
    target = max(limit - required_space, 0)
    freed = 0
    for path, _, size in _cached_files_by_atime(cache_dir()):
        if current - freed <= target:
            break
        try:
            path.unlink()
        except OSError as e:
            raise IoError(str(e))
        # Remove the matching .etag sidecar with its model.
        sidecar = path.with_suffix(".etag")
        if sidecar.exists():
            try:
                sidecar.unlink()
            except OSError:
                pass
        freed += size


def clear_cache() -> None:
    """Delete all files/dirs in the cache dir; no-op if absent (http.rs:124-141)."""
    directory = cache_dir()
    if not directory.exists():
        return
    import shutil

    for p in directory.iterdir():
        try:
            if p.is_file() or p.is_symlink():
                p.unlink()
            elif p.is_dir():
                shutil.rmtree(p)
        except OSError as e:
            raise IoError(str(e))


def get_cache_info() -> str:
    """JSON {"cache_dir","total_size_bytes","file_count","size_limit_bytes"}
    (lib.rs:327-357)."""
    directory = cache_dir()
    total = 0
    count = 0
    if directory.exists():
        for p in directory.iterdir():
            if p.is_file() and p.suffix == ".onnx":
                try:
                    total += p.stat().st_size
                    count += 1
                except OSError:
                    continue
    info = {
        "cache_dir": str(directory),
        "total_size_bytes": total,
        "file_count": count,
        "size_limit_bytes": get_config().cache_size_limit,
    }
    return json.dumps(info, separators=(",", ":"))


class _NotModified(Exception):
    pass


def _download_file(url: str, dest: Path, timeout_s: int, etag: str | None) -> str | None:
    """GET url → dest. Returns the new ETag (or None). Raises _NotModified on
    304, HttpRequestError on HTTP/transport errors, IoError on disk errors.

    Verifies Content-Length when the server sends one, so truncated bodies
    fail like the reference's short-body fixture test (http.rs:345-376).
    """
    req = urllib.request.Request(url, headers={"User-Agent": "infera-tpu/0.4"})
    if etag:
        req.add_header("If-None-Match", etag)
    try:
        resp = urllib.request.urlopen(req, timeout=timeout_s)
    except urllib.error.HTTPError as e:
        if e.code == 304:
            raise _NotModified()
        raise HttpRequestError(f"HTTP status {e.code} for url ({url})")
    except urllib.error.URLError as e:
        raise HttpRequestError(str(e.reason))
    except (TimeoutError, OSError, ValueError) as e:
        raise HttpRequestError(str(e))

    with resp:
        if resp.status == 304:
            raise _NotModified()
        if resp.status >= 400:
            raise HttpRequestError(f"HTTP status {resp.status} for url ({url})")
        new_etag = resp.headers.get("ETag")
        declared_len = resp.headers.get("Content-Length")
        written = 0
        try:
            with open(dest, "wb") as f:
                while True:
                    try:
                        chunk = resp.read(1 << 20)
                    except (TimeoutError, OSError) as e:
                        raise HttpRequestError(str(e))
                    if not chunk:
                        break
                    f.write(chunk)
                    written += len(chunk)
        except OSError as e:
            raise IoError(str(e))
        if declared_len is not None and written != int(declared_len):
            raise HttpRequestError(
                f"truncated body: got {written} of {declared_len} bytes"
            )
    return new_etag


def handle_remote_model(url: str) -> Path:
    """Download-or-revalidate; returns the local cached path (http.rs:179-294)."""
    cfg = get_config()
    directory = cache_dir()
    if not directory.exists():
        log.info(f"Creating cache directory: {directory}")
        try:
            directory.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise CacheDirError(str(e))

    hash_hex = hashlib.sha256(url.encode("utf-8")).hexdigest()
    cached_path = directory / f"{hash_hex}.onnx"
    etag_path = directory / f"{hash_hex}.etag"

    local_etag = None
    if cached_path.exists():
        if etag_path.exists():
            try:
                local_etag = etag_path.read_text().strip()
                log.info(f"Found local ETag metadata for URL: {url}")
            except OSError:
                local_etag = None
        else:
            log.info(f"Cache hit for URL (no ETag metadata): {url}")
            _touch(cached_path)
            return cached_path

    log.info(f"Cache check/download path engaged for URL: {url}, local_etag: {local_etag}")
    temp_path = cached_path.with_suffix(".onnx.part")

    last_error: InferaError | None = None
    try:
        for attempt in range(1, cfg.http_retry_attempts + 1):
            log.debug(f"Download/Validation attempt {attempt}/{cfg.http_retry_attempts} for {url}")
            try:
                new_etag = _download_file(url, temp_path, cfg.http_timeout_s, local_etag)
            except _NotModified:
                log.info(f"Cache hit (ETag verified) for URL: {url}")
                _touch(cached_path)
                return cached_path
            except InferaError as e:
                log.warn(f"Download/Validation attempt {attempt}/{cfg.http_retry_attempts} failed: {e}")
                last_error = e
                if attempt < cfg.http_retry_attempts:
                    delay_s = cfg.http_retry_delay_ms * attempt / 1000.0
                    log.debug(f"Waiting {delay_s}s before retry")
                    time.sleep(delay_s)
                continue
            else:
                log.info(f"Successfully downloaded: {url}")
                try:
                    file_size = temp_path.stat().st_size
                except OSError as e:
                    raise IoError(str(e))
                evict_cache_if_needed(file_size)
                try:
                    os.replace(temp_path, cached_path)
                except OSError as e:
                    raise IoError(str(e))
                if new_etag is not None:
                    try:
                        etag_path.write_text(new_etag)
                    except OSError as e:
                        log.warn(f"Failed to write ETag metadata: {e}")
                else:
                    try:
                        etag_path.unlink(missing_ok=True)
                    except OSError:
                        pass
                return cached_path
    finally:
        # Panic-safe partial-download cleanup (TempFileGuard, http.rs:15-43):
        # any exit that did not commit via os.replace removes the temp file.
        try:
            temp_path.unlink(missing_ok=True)
        except OSError:
            pass

    log.error(f"Failed to download/validate after {cfg.http_retry_attempts} attempts: {url}")
    raise last_error if last_error else HttpRequestError("Unknown error")
