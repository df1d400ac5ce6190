"""Shared disk-backed calibration-cache for the self-calibrating
dispatchers (in the port: `ops/decode.py`).

A copy of the JAX package's `common/calib_cache.py`. A registry memoizes
micro-A/B verdicts in a JSON file under the engine's data root
(env-overridable per registry), an in-memory view guarded by a lock, a
`version` stamp plus optional inventory fields that invalidate the whole
file when the impl set changes, and an atomic mkstemp + os.replace
publish so readers never see a torn file.

The single lock covers mutation AND the file write: a concurrent
store_entry can never clobber a newer payload with a stale one (the
old per-registry copies serialized the payload under the lock but
raced the os.replace outside it)."""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Callable


class CalibCache:
    """One registry's calibration file: `env_var` overrides the full
    path, otherwise `filename` under the configured dir (engine data
    root) or the tmpdir fallback. `inventory`, when given, returns
    extra top-level fields that must match on load (impl-set change
    => full recalibration) and are rewritten on every store."""

    def __init__(self, *, env_var: str, filename: str, version: int,
                 tmp_prefix: str,
                 inventory: Callable[[], dict] | None = None) -> None:
        self._env_var = env_var
        self._filename = filename
        self._version = version
        self._tmp_prefix = tmp_prefix
        self._inventory = inventory
        self._lock = threading.Lock()
        self._dir_override: str | None = None
        self._mem: dict | None = None

    def configure_dir(self, path: str) -> None:
        """Point the cache under the engine's data root (called by
        storage bring-up); the env var still overrides with a full
        file path."""
        with self._lock:
            self._dir_override = path
            self._mem = None

    def path(self) -> str:
        env = os.environ.get(self._env_var)
        if env:
            return env
        base = self._dir_override or os.path.join(
            tempfile.gettempdir(), "horaedb-tpu"
        )
        return os.path.join(base, self._filename)

    def reset(self, memory_only: bool = False) -> None:
        """Drop the in-memory view (tests); optionally leave the file."""
        with self._lock:
            self._mem = None
        if not memory_only:
            try:
                os.unlink(self.path())
            except OSError:
                pass

    def load(self) -> dict:
        with self._lock:
            if self._mem is not None:
                return self._mem
            data: dict = {}
            try:
                with open(self.path(), encoding="utf-8") as f:
                    raw = json.load(f)
                expect = self._inventory() if self._inventory else {}
                if (
                    isinstance(raw, dict)
                    and raw.get("version") == self._version
                    and all(raw.get(k) == v for k, v in expect.items())
                ):
                    data = raw
                # registry changed (new/removed impls or format):
                # recalibrate from scratch
            except (OSError, ValueError):
                pass
            self._mem = data
            return data

    def store_entry(self, key: str, entry: dict) -> None:
        path = self.path()
        with self._lock:
            data = self._mem if self._mem else {}
            data.setdefault("version", self._version)
            if self._inventory:
                data.update(self._inventory())
            data.setdefault("entries", {})[key] = entry
            self._mem = data
            payload = json.dumps(data, indent=1, sort_keys=True)
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                fd, tmp = tempfile.mkstemp(
                    dir=os.path.dirname(path) or ".",
                    prefix=self._tmp_prefix,
                )
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    f.write(payload)
                # atomic publish: readers never see a torn file
                os.replace(tmp, path)
            except OSError:
                # cache is an optimization; an unwritable root costs a
                # re-A/B, nothing else
                pass
