"""Decode kernels for encoded SST lanes, and the calibrated dispatcher that
picks the host funnel or the card per lane.

A port of the JAX package's `ops/decode.py`. The four kernels keep the
JAX catalog names and compute what the XLA kernels compute, bit for bit
(no float arithmetic touches a value; floats come out as bitcasts):

  decode_unpack  dict lanes: the `width`-bit ids (width <= 32) of an
                 LSB-first stream of u32 words, then the dictionary gather;
  decode_dod     delta-of-delta timestamps: unpack, unzigzag, two prefix
                 sums mod 2^64 from (first, first_delta);
  decode_xor     Gorilla XOR floats: unpack, prefix XOR from the first
                 value's bits;
  decode_rle     run expansion: each page's run lengths, read from its
                 payload and scanned on the device, give the runs' start
                 rows; each row takes the value of the last run that
                 starts at or before it.

The JAX kernels run once per page, padded to a 1,024-row granule. Here
`decode_pages` decodes every kept page of one lane in one launch: the
pages' payloads go up as one u32 word lane with a zero guard word, beside
a page table of (out_off, rows, word_off, width, p0, p1), and each kernel
runs one block per page (`csrc/bitunpack.cuh`). On a CUDA tensor each
wrapper launches its kernel (`csrc/decode_*.cu`); on a CPU tensor it runs
the plain PyTorch version beside it (int64 arithmetic with explicit
masks), which the tests hold against the JAX kernels.

The device envelope is the JAX package's: a page of width > 32 (a value
may then span three words), or a codec/dtype a kernel does not take, is
left to the host funnel (`storage/encoding.py::decode_lane` fills it and
`page_counts` counts it per lane).

Dispatch is measured: a micro-A/B per (platform, codec) times the host
funnel against the device lane once and persists the winner (common/
calib_cache.py); `HORAEDB_DECODE_IMPL` pins it (host | device | raw |
auto), where `raw` turns the encoded read path off. A device lane that
fails makes the calibration fail: a `host` verdict comes from the timing,
never from a failure.

    python -m horaedb_tpu_torch.ops.decode --sweep [N_ROWS] [--device cuda]

prints the A/B of every codec at N_ROWS as one JSON line.
"""

from __future__ import annotations

import contextvars
import ctypes
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device, to_device
from horaedb_tpu_torch.common.calib_cache import CalibCache
from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.ops import _build
from horaedb_tpu_torch.ops._build import KernelError

logger = logging.getLogger(__name__)

DECODE_IMPLS = ("host", "device")
DEVICE_CODECS = ("dod", "xor", "dict", "rle")
# device bit-unpack envelope: one value spans at most two u32 words
DEVICE_MAX_WIDTH = 32
PAGE_FIELDS = 6  # out_off, rows, word_off, width, p0, p1
# the port's verdicts are not the JAX package's: a file shared through
# HORAEDB_DECODE_CACHE with the JAX package recalibrates instead of reading them
CALIB_VERSION = "torch/1"

_MASK32 = 0xFFFF_FFFF
_U64 = 1 << 64


def _i64(v: int) -> int:
    """A JSON integer (signed, or u64 bits up to 2^64 - 1) as int64 bits."""
    return ((int(v) + (1 << 63)) % _U64) - (1 << 63)


# ---------------------------------------------------------------------------
# pages decoded on the device vs on the host, per lane
# ---------------------------------------------------------------------------

_pages_lock = threading.Lock()
_pages: dict[str, dict[str, int]] = {}


def note_pages(lane: str, device: int, host: int) -> None:
    with _pages_lock:
        c = _pages.setdefault(lane, {"device": 0, "host": 0})
        c["device"] += device
        c["host"] += host


def page_counts() -> dict[str, dict[str, int]]:
    with _pages_lock:
        return {k: dict(v) for k, v in _pages.items()}


def reset_page_counts() -> None:
    with _pages_lock:
        _pages.clear()


# ---------------------------------------------------------------------------
# kernels: the wrappers and their plain versions
# ---------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise KernelError(msg)


def _check(name: str, words: torch.Tensor, table: torch.Tensor, itemsize: int) -> None:
    _require(words.dtype == torch.int32 and words.dim() == 1 and words.numel() >= 1
             and words.is_contiguous(), f"{name}: words must be a contiguous int32 lane "
             "with its guard word")
    _require(table.dtype == torch.int64 and table.dim() == 2 and table.shape[1] == PAGE_FIELDS
             and table.is_contiguous(), f"{name}: the page table must be int64 [pages, 6]")
    _require(table.device == words.device, f"{name}: lanes must share one device")
    _require(itemsize in (4, 8), f"{name}: itemsize {itemsize} is not 4 or 8")


def _out(n: int, itemsize: int, device) -> torch.Tensor:
    return torch.empty(n, dtype=torch.int64 if itemsize == 8 else torch.int32, device=device)


def _launch(name: str, argtypes: list, dev: torch.device, *args) -> None:
    """Launch decoder `name` on `dev`'s current stream (`_build.launch`:
    no device switch when `dev` is current, the raw stream handle)."""
    fn = _build.kernel(name, f"{name}_launch", argtypes + [ctypes.c_void_p])
    _build.launch(name, fn, dev, *args)


def _row_pages(table: torch.Tensor, n: int):
    """Page index, in-page row index and page-table row of every output row."""
    page = torch.repeat_interleave(torch.arange(table.shape[0], device=table.device),
                                   table[:, 1])
    t = table[page]
    return page, torch.arange(n, device=table.device) - t[:, 0], t


def _unpack_plain(words: torch.Tensor, word_off, bit, width) -> torch.Tensor:
    """The `width`-bit value at `bit` of the stream at `word_off`, per row,
    in int64. The high word enters sign-extended, so `hi << 32` keeps its
    bits without overflow. `>>` on int64 is arithmetic: it shifts copies of
    bit 63 in at the top, but the mask keeps bits [off, off + width) of the
    pair, and off + width <= 63 for width <= 32 (off <= 31), so no copied
    sign bit survives the mask."""
    last = words.numel() - 1
    wi = word_off + (bit >> 5)
    lo = words[wi.clamp(0, last)].long() & _MASK32
    hi = words[(wi + 1).clamp(0, last)].long()
    pair = (hi << 32) | lo
    mask = (torch.ones_like(width) << width) - 1
    return torch.where(width > 0, (pair >> (bit & 31)) & mask, 0)


def _page_base(cs: torch.Tensor, table: torch.Tensor, page: torch.Tensor) -> torch.Tensor:
    """Per row, the running total `cs` held just before its page's first row
    (0 for the first page)."""
    start = table[:, 0]
    prev = cs[(start - 1).clamp(0, cs.numel() - 1)]
    return torch.where(start > 0, prev, 0)[page]


def _seg_cumsum(x: torch.Tensor, table: torch.Tensor, page: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum per page. int64 sums wrap mod 2^64, and so does
    the subtraction of the page's base, as the JAX kernel's uint64 adds."""
    cs = torch.cumsum(x, 0)
    return cs - _page_base(cs, table, page)


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR (torch has no cumulative XOR): a log-step scan
    with shifted copies."""
    g = x.clone()
    s = 1
    while s < g.numel():
        g[s:] = g[s:] ^ g[:-s]
        s <<= 1
    return g


def _narrow(v: torch.Tensor, itemsize: int) -> torch.Tensor:
    """int64 bits -> the output lane: as they are, or their low 32 bits."""
    if itemsize == 8:
        return v
    return (((v & _MASK32) ^ 0x8000_0000) - 0x8000_0000).to(torch.int32)


def decode_unpack_plain(words, table, dict_bits, n: int):
    """Plain version of decode_unpack: (rows, count of ids past the dictionary)."""
    itemsize = dict_bits.element_size()
    if n == 0:
        return _out(0, itemsize, words.device), torch.zeros(1, dtype=torch.int32,
                                                            device=words.device)
    _page, i, t = _row_pages(table, n)
    ids = _unpack_plain(words, t[:, 2], i * t[:, 3], t[:, 3])
    k = dict_bits.numel()
    ok = ids < k
    vals = dict_bits[ids.clamp(0, max(k - 1, 0))] if k else _out(n, itemsize, words.device)
    out = torch.where(ok, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    return out, (~ok).sum().to(torch.int32).reshape(1)


def decode_dod_plain(words, table, n: int, itemsize: int) -> torch.Tensor:
    """Plain version of decode_dod."""
    if n == 0:
        return _out(0, itemsize, words.device)
    page, i, t = _row_pages(table, n)
    width = t[:, 3]
    z = _unpack_plain(words, t[:, 2], (i - 2).clamp(min=0) * width, width)
    dd = torch.where(i >= 2, (z >> 1) ^ -(z & 1), 0)  # unzigzag; z < 2^32
    d = torch.where(i >= 1, t[:, 5], 0) + _seg_cumsum(dd, table, page)
    return _narrow(t[:, 4] + _seg_cumsum(d, table, page), itemsize)


def decode_xor_plain(words, table, n: int, itemsize: int) -> torch.Tensor:
    """Plain version of decode_xor."""
    if n == 0:
        return _out(0, itemsize, words.device)
    page, i, t = _row_pages(table, n)
    width = t[:, 3]
    x = _unpack_plain(words, t[:, 2], (i - 1).clamp(min=0) * width, width)
    g = _prefix_xor(torch.where(i >= 1, x, t[:, 4]))
    return _narrow(g ^ _page_base(g, table, page), itemsize)


def decode_rle_plain(words, table, n: int, itemsize: int) -> torch.Tensor:
    """Plain version of decode_rle. A page's run lengths are the u32s after
    its run values. Each page's runs cover its rows (stage_pages checks
    it) and out_off counts the rows before a page, so the running sum of
    every page's lengths, in page order, is one nondecreasing lane of run
    ends in output rows, searched once."""
    if n == 0:
        return _out(0, itemsize, words.device)
    page, _i, t = _row_pages(table, n)
    runs = table[:, 4]
    run_first = torch.cumsum(runs, 0) - runs  # each page's first run, over the lane
    run_page = torch.repeat_interleave(torch.arange(table.shape[0], device=table.device), runs)
    k = torch.arange(run_page.numel(), device=table.device) - run_first[run_page]
    lens = words[table[run_page, 2] + runs[run_page] * (itemsize // 4) + k].long() & _MASK32
    g = torch.searchsorted(torch.cumsum(lens, 0), torch.arange(n, device=words.device),
                           right=True)
    r = torch.minimum((g - run_first[page]).clamp(min=0), (t[:, 4] - 1).clamp(min=0))
    last = words.numel() - 1
    if itemsize == 8:
        at = t[:, 2] + 2 * r
        v = (words[(at + 1).clamp(max=last)].long() << 32) | (words[at.clamp(max=last)].long()
                                                             & _MASK32)
        return v
    return words[(t[:, 2] + r).clamp(max=last)].clone()


def decode_unpack(words, table, dict_bits, n: int):
    """Rows of dict pages: kernel `decode_unpack` on a CUDA tensor,
    `decode_unpack_plain` on a CPU one. `dict_bits` holds the dictionary
    as the lane dtype's bits (int64 or int32); returns (rows of that type,
    int32[1] count of ids past the dictionary)."""
    itemsize = dict_bits.element_size()
    _check("decode_unpack", words, table, itemsize)
    _require(dict_bits.dim() == 1 and dict_bits.is_contiguous()
             and dict_bits.device == words.device, "decode_unpack: bad dictionary lane")
    if words.device.type == "cpu":
        return decode_unpack_plain(words, table, dict_bits, n)
    out = _out(n, itemsize, words.device)
    bad = torch.zeros(1, dtype=torch.int32, device=words.device)
    if n == 0:
        return out, bad  # no rows: nothing to launch
    p = ctypes.c_void_p
    _launch("decode_unpack", [p, p, ctypes.c_int64, p, ctypes.c_int64, ctypes.c_int, p, p],
            words.device, words.data_ptr(), table.data_ptr(), table.shape[0],
            dict_bits.data_ptr(), dict_bits.numel(), itemsize, out.data_ptr(), bad.data_ptr())
    return out, bad


def decode_dod(words, table, n: int, itemsize: int) -> torch.Tensor:
    """Rows of dod pages (int64, or int32 bits): kernel `decode_dod` on a
    CUDA tensor, `decode_dod_plain` on a CPU one."""
    _check("decode_dod", words, table, itemsize)
    if words.device.type == "cpu":
        return decode_dod_plain(words, table, n, itemsize)
    out = _out(n, itemsize, words.device)
    if n == 0:
        return out  # no rows: nothing to launch
    p = ctypes.c_void_p
    _launch("decode_dod", [p, p, ctypes.c_int64, ctypes.c_int, p], words.device,
            words.data_ptr(), table.data_ptr(), table.shape[0], itemsize, out.data_ptr())
    return out


def decode_xor(words, table, n: int, itemsize: int) -> torch.Tensor:
    """Bits of xor pages (int64 for f64, int32 for f32): kernel
    `decode_xor` on a CUDA tensor, `decode_xor_plain` on a CPU one."""
    _check("decode_xor", words, table, itemsize)
    if words.device.type == "cpu":
        return decode_xor_plain(words, table, n, itemsize)
    out = _out(n, itemsize, words.device)
    if n == 0:
        return out  # no rows: nothing to launch
    p = ctypes.c_void_p
    _launch("decode_xor", [p, p, ctypes.c_int64, ctypes.c_int, p], words.device,
            words.data_ptr(), table.data_ptr(), table.shape[0], itemsize, out.data_ptr())
    return out


def decode_rle(words, table, n: int, itemsize: int) -> torch.Tensor:
    """Rows of rle pages: kernel `decode_rle` on a CUDA tensor,
    `decode_rle_plain` on a CPU one. A page's payload holds its p0 run
    values, then their u32 lengths, which add up to its rows."""
    _check("decode_rle", words, table, itemsize)
    if words.device.type == "cpu":
        return decode_rle_plain(words, table, n, itemsize)
    out = _out(n, itemsize, words.device)
    if n == 0:
        return out  # no rows: nothing to launch
    p = ctypes.c_void_p
    _launch("decode_rle", [p, p, ctypes.c_int64, ctypes.c_int, p], words.device,
            words.data_ptr(), table.data_ptr(), table.shape[0], itemsize, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# the lane-level entry: every kept page of one lane in one launch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DevicePages:
    """One lane's kept pages as the kernels take them (tensors on one
    device): the word lane, the page table, and for dict the dictionary's
    bits."""

    codec: str
    dtype: np.dtype
    rows: int
    words: torch.Tensor
    table: torch.Tensor
    dict_bits: torch.Tensor | None = None


def in_envelope(codec: str, dt: np.dtype, page, dict_values) -> bool:
    """Can a kernel decode this page? (`decode_page_device`'s None.)"""
    if page.width > DEVICE_MAX_WIDTH or dt.itemsize not in (4, 8):
        return False
    if codec == "dod":
        return np.issubdtype(dt, np.signedinteger)
    if codec == "xor":
        return dt in (np.dtype(np.float64), np.dtype(np.float32))
    if codec == "dict":
        return dict_values is not None
    return codec == "rle"


def _page_words(codec: str, page, itemsize: int) -> int:
    """Words of payload the page's rows need."""
    if codec == "rle":
        return page.p0 * (itemsize + 4) // 4
    stream = {"dict": page.rows, "dod": page.rows - 2, "xor": page.rows - 1}[codec]
    return (max(0, stream) * page.width + 31) // 32


def stage_pages(codec: str, dtype, payload: bytes, pages: list, dict_values,
                device) -> DevicePages:
    """Check the pages' metadata against the payload (a sidecar whose pages
    do not add up raises HoraeError) and put their payload, page table and,
    for dict, the dictionary's bits on `device`. Pages must be inside the
    envelope."""
    dt = np.dtype(dtype)
    dev = resolve_device(device)
    itemsize = dt.itemsize
    table = np.zeros((len(pages), PAGE_FIELDS), np.int64)
    contiguous = all(b.off == a.off + a.length for a, b in zip(pages, pages[1:]))
    base = pages[0].off if pages else 0
    out_off = word_at = 0
    for k, p in enumerate(pages):
        ensure(p.rows >= 0 and p.off >= 0 and p.off % 4 == 0 and p.length % 4 == 0
               and p.off + p.length <= len(payload),
               f"{codec} page {k}: payload [{p.off}, {p.off + p.length}) is not a word "
               f"range of the lane's {len(payload)} bytes")
        ensure(_page_words(codec, p, itemsize) * 4 <= p.length,
               f"{codec} page {k}: {p.rows} rows need more than its {p.length} bytes")
        wo = (p.off - base) // 4 if contiguous else word_at
        p0, p1 = _i64(p.p0), _i64(p.p1)
        if codec == "rle":
            ensure(p.p0 >= (1 if p.rows else 0), f"rle page {k}: {p.p0} runs for {p.rows} rows")
            ensure(p.rows < 1 << 32, f"rle page {k}: {p.rows} rows, not under 2^32")
        table[k] = (out_off, p.rows, wo, p.width, p0, p1)
        out_off += p.rows
        word_at += p.length // 4
    if contiguous and pages:
        body = memoryview(payload)[base:pages[-1].off + pages[-1].length]
    else:
        body = b"".join(payload[p.off:p.off + p.length] for p in pages)
    words = np.zeros(len(body) // 4 + 1, np.uint32)  # + the guard word
    words[:-1] = np.frombuffer(body, "<u4")
    if codec == "rle":
        _check_runs(table, words, itemsize)
    staged = dict(codec=codec, dtype=dt, rows=out_off,
                  words=to_device(words.view(np.int32), dev), table=to_device(table, dev))
    if codec == "dict":
        from horaedb_tpu_torch.storage.encoding import dict_array

        bits = dict_array(dict_values, dt).view(np.int64 if itemsize == 8 else np.int32)
        staged["dict_bits"] = to_device(bits, dev)
    return DevicePages(**staged)


def _check_runs(table: np.ndarray, words: np.ndarray, itemsize: int) -> None:
    """Each rle page's run lengths (the u32s after its p0 values) add up to
    its rows: one gather of every page's lengths and one reduceat."""
    runs, rows = table[:, 4], table[:, 1]
    run_first = np.cumsum(runs) - runs
    at = table[:, 2] + runs * (itemsize // 4) - run_first  # + the run's index over the lane
    lens = words[np.repeat(at, runs) + np.arange(int(runs.sum()))].astype(np.int64)
    cover = np.zeros(len(table), np.int64)
    held = runs > 0
    if held.any():
        cover[held] = np.add.reduceat(lens, run_first[held])
    bad = np.flatnonzero(cover != rows)
    if bad.size:
        k = int(bad[0])
        ensure(False, f"rle page {k}: runs cover {int(cover[k])} rows, not {int(rows[k])}")


def run_pages(s: DevicePages) -> torch.Tensor:
    """The staged pages' rows, as the lane dtype's bits (int64 or int32)."""
    itemsize = s.dtype.itemsize
    if s.codec == "dict":
        out, bad = decode_unpack(s.words, s.table, s.dict_bits, s.rows)
        ensure(int(bad.item()) == 0, f"dict ids past the dictionary in {int(bad.item())} rows")
        return out
    if s.codec == "dod":
        return decode_dod(s.words, s.table, s.rows, itemsize)
    if s.codec == "xor":
        return decode_xor(s.words, s.table, s.rows, itemsize)
    return decode_rle(s.words, s.table, s.rows, itemsize)


def run_pages_plain(s: DevicePages) -> torch.Tensor:
    """`run_pages` through the plain versions, on the tensors' own device:
    what a kernel is held against on the card."""
    itemsize = s.dtype.itemsize
    if s.codec == "dict":
        return decode_unpack_plain(s.words, s.table, s.dict_bits, s.rows)[0]
    if s.codec == "dod":
        return decode_dod_plain(s.words, s.table, s.rows, itemsize)
    if s.codec == "xor":
        return decode_xor_plain(s.words, s.table, s.rows, itemsize)
    return decode_rle_plain(s.words, s.table, s.rows, itemsize)


def decode_pages(codec: str, dtype, payload: bytes, pages: list, dict_values,
                 device=DEFAULT_DEVICE) -> np.ndarray:
    """The rows of `pages` (all inside the envelope) of one lane, in page
    order, decoded on `device` in one launch and copied to the host.

    A dict lane whose pages are all width 0 launches nothing: every id is
    0, as in the JAX package."""
    dt = np.dtype(dtype)
    rows = sum(p.rows for p in pages)
    if rows == 0:
        return np.empty(0, dt)
    if codec == "dict" and all(p.width == 0 for p in pages):
        from horaedb_tpu_torch.storage.encoding import dict_array

        vals = dict_array(dict_values, dt)
        ensure(len(vals) > 0, "dict lane with rows and an empty dictionary")
        return np.full(rows, vals[0], dt)
    staged = stage_pages(codec, dt, payload, pages, dict_values, device)
    return run_pages(staged).cpu().numpy().view(dt)


@dataclass(frozen=True)
class _Page:
    rows: int
    off: int
    length: int
    width: int
    p0: int
    p1: int


def decode_page_device(codec: str, dtype: str, payload: bytes, rows: int, width: int,
                       p0: int, p1: int, dict_values, device=DEFAULT_DEVICE) -> np.ndarray | None:
    """Decode ONE encoded page on `device` into the exact host array; None
    when the page is outside the device envelope (the caller falls back to
    the host funnel). The one-page call of the lane-level kernels."""
    dt = np.dtype(dtype)
    if rows == 0:
        return np.empty(0, dt)
    page = _Page(rows, 0, len(payload), width, p0, p1)
    if codec not in DEVICE_CODECS or not in_envelope(codec, dt, page, dict_values):
        return None
    return decode_pages(codec, dt, payload, [page], dict_values, device)


# ---------------------------------------------------------------------------
# calibration + dispatch
# ---------------------------------------------------------------------------

_last_choice_ctx: "contextvars.ContextVar[str | None]" = \
    contextvars.ContextVar("horaedb_decode_last_choice", default=None)
_last_choice_global: str = "host"

_calib_cache = CalibCache(
    env_var="HORAEDB_DECODE_CACHE",
    filename="torch_decode_calib.json",
    version=CALIB_VERSION,
    tmp_prefix=".torch_decode_calib.",
)


def configure_cache_dir(path: str) -> None:
    """Point the calibration cache under the engine's data root;
    HORAEDB_DECODE_CACHE overrides with a full file path."""
    _calib_cache.configure_dir(path)


def cache_path() -> str:
    return _calib_cache.path()


def reset_cache(memory_only: bool = False) -> None:
    """Drop the in-memory view (tests); optionally leave the file."""
    _calib_cache.reset(memory_only)


def _synth_lane(codec: str, n: int):
    """Synthetic encoded lane of one codec class for the micro-A/B (the
    JAX package's lanes: its xor lane is normal floats, wider than 32 bits,
    so the device side of that A/B runs the host funnel on every page)."""
    from horaedb_tpu_torch.storage import encoding as enc_mod

    rng = np.random.default_rng(0xDEC)
    if codec == "dod":
        arr = (np.arange(n, dtype=np.int64) * 15_000 + rng.integers(-4, 5, n))
        lane = enc_mod._encode_dod(arr, enc_mod.DEFAULT_PAGE_ROWS)
    elif codec == "xor":
        arr = rng.normal(size=n).astype(np.float64)
        lane = enc_mod._encode_xor(arr, enc_mod.DEFAULT_PAGE_ROWS)
    elif codec == "dict":
        arr = rng.integers(0, 256, n, dtype=np.int64)
        lane = enc_mod._encode_dict(arr, enc_mod.DEFAULT_PAGE_ROWS, 4096)
    else:  # rle
        arr = np.repeat(rng.integers(0, 1 << 40, max(1, n // 64), dtype=np.int64), 64)[:n]
        lane = enc_mod._encode_rle(arr, enc_mod.DEFAULT_PAGE_ROWS)
    lane.name = codec
    return lane, arr


def _calibrate(codec: str, device) -> dict:
    """Time both impls on a synthetic lane. Either impl raising (a kernel
    that does not build or launch) fails the calibration."""
    from horaedb_tpu_torch.storage import encoding as enc_mod

    try:
        n = int(os.environ.get("HORAEDB_DECODE_CALIB_N", str(1 << 17)))
    except ValueError:
        n = 1 << 17
    lane, arr = _synth_lane(codec, n)
    ab: dict[str, float] = {}
    for impl in DECODE_IMPLS:
        out = enc_mod.decode_lane(lane, impl=impl, device=device)
        ensure(np.array_equal(
            out.view(np.uint64) if out.dtype == np.float64 else out,
            arr.view(np.uint64) if arr.dtype == np.float64 else arr,
        ), f"decode impl {impl} not bit-exact on {codec}")
        t0 = time.perf_counter()
        for _ in range(2):
            enc_mod.decode_lane(lane, impl=impl, device=device)
        ab[impl] = round(n / max((time.perf_counter() - t0) / 2, 1e-9))
    best = max(ab, key=ab.get)
    return {"impl": best, "ab": ab, "n": n, "calibrated_unix": int(time.time())}


def calibration_entry(codec: str, device=DEFAULT_DEVICE) -> tuple[dict, str]:
    """(verdict, "cache" or "calibrated") for `codec` on `device`'s
    platform (cuda or cpu)."""
    dev = resolve_device(device)
    key = f"{dev.type}/{codec}"
    entry = (_calib_cache.load().get("entries") or {}).get(key)
    if entry is not None:
        return entry, "cache"
    entry = _calibrate(codec, dev)
    _calib_cache.store_entry(key, entry)
    return entry, "calibrated"


def _record(name: str) -> str:
    global _last_choice_global
    _last_choice_ctx.set(name)
    _last_choice_global = name
    return name


def scan_mode() -> str:
    """HORAEDB_DECODE_IMPL in {auto, host, device, raw}; `raw` turns the
    encoded read path off. An unknown value degrades to `auto` with a
    once-per-value warning, as in the JAX package."""
    mode = os.environ.get("HORAEDB_DECODE_IMPL", "auto")
    if mode not in ("auto", "host", "device", "raw"):
        _warn_bad_mode(mode)
        return "auto"
    return mode


@lru_cache(maxsize=8)
def _warn_bad_mode(mode: str) -> None:
    logger.warning("HORAEDB_DECODE_IMPL=%r is not one of auto/host/device/raw; "
                   "treating as 'auto'", mode)


def choose(codec: str, n: int, device=DEFAULT_DEVICE) -> str:
    """The decode impl for one lane of `n` rows: env pin > calibration
    (micro-A/B on first use per platform and codec). Lanes under 2,048
    rows pin to host; raw and null lanes have no device decode and
    resolve to host."""
    if codec not in DEVICE_CODECS:
        scan_mode()  # still validate the env pin
        return _record("host")
    mode = scan_mode()
    if mode in ("host", "device"):
        return _record(mode)
    if n < 2048:
        return _record("host")
    entry, _source = calibration_entry(codec, device)
    return _record(entry["impl"])


def last_choice() -> str:
    ctx = _last_choice_ctx.get()
    return ctx if ctx is not None else _last_choice_global


def _sweep(n: int, device) -> dict:
    """A fresh micro-A/B of every codec at `n` rows on `device`: rows/s per
    (codec, impl) and the winner."""
    dev = resolve_device(device)
    os.environ["HORAEDB_DECODE_CALIB_N"] = str(n)
    reset_cache(memory_only=True)
    codecs = {}
    for codec in DEVICE_CODECS:
        entry = _calibrate(codec, dev)
        codecs[codec] = {"impl": entry["impl"], "rows_per_sec": entry["ab"]}
    return {"metric": "decode_sweep", "platform": dev.type, "n": n, "codecs": codecs}


def main(argv: "list[str] | None" = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", type=int, nargs="?", const=1 << 20, metavar="N_ROWS",
                    help="A/B host vs device decode for every codec at N_ROWS and print "
                         "one JSON line")
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.sweep:
        print(json.dumps(_sweep(args.sweep, args.device)))
        return
    ap.print_help()


if __name__ == "__main__":
    main()
