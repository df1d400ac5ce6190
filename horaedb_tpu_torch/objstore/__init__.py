"""Object-store abstraction: the durability layer of the port.

A copy of the JAX package's `objstore/__init__.py` (`ObjectStore`,
`MemStore`, `LocalStore`, `NotFound`, `PreconditionFailed`): the same
put/get/list/delete/head contract over a flat namespace of `/`-separated
keys, so an SST tree written by either package reads through the other.
All methods are async; `LocalStore` runs blocking file IO in threads. The
conditional-GET watch and the S3, resilient and chaos stores wait for the
slices that need them.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass

from horaedb_tpu_torch.common.error import HoraeError

# unique per-attempt suffix stream for LocalStore.put_if_absent sidecars
_ifabsent_seq = itertools.count()


@dataclass(frozen=True)
class ObjectMeta:
    """Result of `head`: the subset of metadata the engine uses."""

    path: str
    size: int


class NotFound(HoraeError):
    """Raised by get/head/delete on a missing object."""


class PreconditionFailed(HoraeError):
    """Raised by put_if_absent when the object already exists."""


class ObjectStore(ABC):
    """put/get/list/delete/head over a flat namespace of `/`-separated keys."""

    @abstractmethod
    async def put(self, path: str, data: bytes) -> None: ...

    async def put_if_absent(self, path: str, data: bytes) -> None:
        """Atomic create-if-absent; raises PreconditionFailed if the key
        exists. Stores that cannot provide it raise."""
        raise HoraeError(f"{type(self).__name__} does not support conditional puts")

    @abstractmethod
    async def get(self, path: str) -> bytes: ...

    @abstractmethod
    async def list(self, prefix: str) -> list[ObjectMeta]: ...

    @abstractmethod
    async def delete(self, path: str) -> None: ...

    @abstractmethod
    async def head(self, path: str) -> ObjectMeta: ...

    def local_path(self, path: str) -> str | None:
        """Local filesystem path for readers that need one (parquet mmap);
        None for stores without one, whose readers `get` the bytes."""
        return None

    async def put_stream(self, path: str, chunks) -> int:
        """Streaming put from an async iterator of bytes chunks. The default
        accumulates then puts; stores with real backends override to bound
        memory at chunk granularity."""
        parts = []
        async for c in chunks:
            parts.append(c)
        data = await asyncio.to_thread(b"".join, parts)
        await self.put(path, data)
        return len(data)


class MemStore(ObjectStore):
    """In-memory store for tests."""

    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._lock = asyncio.Lock()

    async def put(self, path: str, data: bytes) -> None:
        async with self._lock:
            self._objects[path] = bytes(data)

    async def put_if_absent(self, path: str, data: bytes) -> None:
        async with self._lock:
            if path in self._objects:
                raise PreconditionFailed(f"object exists: {path}")
            self._objects[path] = bytes(data)

    async def get(self, path: str) -> bytes:
        try:
            return self._objects[path]
        except KeyError:
            raise NotFound(f"object not found: {path}") from None

    async def list(self, prefix: str) -> list[ObjectMeta]:
        norm = prefix.rstrip("/") + "/" if prefix else ""
        out = [ObjectMeta(path=k, size=len(v)) for k, v in self._objects.items()
               if k.startswith(norm)]
        out.sort(key=lambda m: m.path)
        return out

    async def delete(self, path: str) -> None:
        async with self._lock:
            if self._objects.pop(path, None) is None:
                raise NotFound(f"object not found: {path}")

    async def head(self, path: str) -> ObjectMeta:
        try:
            return ObjectMeta(path=path, size=len(self._objects[path]))
        except KeyError:
            raise NotFound(f"object not found: {path}") from None


class LocalStore(ObjectStore):
    """Object store over a local directory. Puts are atomic: the object
    appears under its name only after a rename."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _fs_path(self, path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, path.lstrip("/")))
        if p != self.root and not p.startswith(self.root + os.sep):
            raise HoraeError(f"path escapes store root: {path}")
        return p

    async def put(self, path: str, data: bytes) -> None:
        def _put() -> None:
            fs = self._fs_path(path)
            os.makedirs(os.path.dirname(fs), exist_ok=True)
            tmp = fs + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, fs)

        await asyncio.to_thread(_put)

    async def put_if_absent(self, path: str, data: bytes) -> None:
        def _put() -> None:
            fs = self._fs_path(path)
            os.makedirs(os.path.dirname(fs), exist_ok=True)
            # write a sidecar unique per attempt, then hard-link it to the
            # final name: link(2) fails with EEXIST atomically
            tmp = fs + f".{os.getpid()}.{threading.get_ident()}.{next(_ifabsent_seq)}.ifabsent"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            try:
                os.link(tmp, fs)
            except FileExistsError:
                raise PreconditionFailed(f"object exists: {path}") from None
            finally:
                try:
                    os.remove(tmp)
                except OSError:
                    pass

        await asyncio.to_thread(_put)

    async def put_stream(self, path: str, chunks) -> int:
        """Streaming put; atomic: an aborted stream leaves nothing at
        `path`. Returns total bytes written."""
        fs = self._fs_path(path)
        os.makedirs(os.path.dirname(fs), exist_ok=True)
        tmp = fs + ".tmp"
        total = 0
        f = await asyncio.to_thread(open, tmp, "wb")
        try:
            async for chunk in chunks:
                await asyncio.to_thread(f.write, chunk)
                total += len(chunk)
            await asyncio.to_thread(f.flush)
            await asyncio.to_thread(os.fsync, f.fileno())
            await asyncio.to_thread(f.close)
            await asyncio.to_thread(os.replace, tmp, fs)
        except BaseException:
            try:
                f.close()
            finally:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            raise
        return total

    async def get(self, path: str) -> bytes:
        def _get() -> bytes:
            try:
                with open(self._fs_path(path), "rb") as f:
                    return f.read()
            except FileNotFoundError:
                raise NotFound(f"object not found: {path}") from None

        return await asyncio.to_thread(_get)

    async def list(self, prefix: str) -> list[ObjectMeta]:
        def _list() -> list[ObjectMeta]:
            base = self._fs_path(prefix) if prefix else self.root
            out: list[ObjectMeta] = []
            if not os.path.isdir(base):
                return out
            for dirpath, _dirnames, filenames in os.walk(base):
                for name in filenames:
                    if name.endswith((".tmp", ".ifabsent")):
                        continue
                    fs = os.path.join(dirpath, name)
                    rel = os.path.relpath(fs, self.root).replace(os.sep, "/")
                    out.append(ObjectMeta(path=rel, size=os.path.getsize(fs)))
            out.sort(key=lambda m: m.path)
            return out

        return await asyncio.to_thread(_list)

    async def delete(self, path: str) -> None:
        def _delete() -> None:
            try:
                os.remove(self._fs_path(path))
            except FileNotFoundError:
                raise NotFound(f"object not found: {path}") from None

        await asyncio.to_thread(_delete)

    async def head(self, path: str) -> ObjectMeta:
        def _head() -> ObjectMeta:
            try:
                return ObjectMeta(path=path, size=os.path.getsize(self._fs_path(path)))
            except FileNotFoundError:
                raise NotFound(f"object not found: {path}") from None

        return await asyncio.to_thread(_head)

    def local_path(self, path: str) -> str | None:
        return self._fs_path(path)
