"""Build and load the port's CUDA kernels, and count their launches.

Each kernel is one library (two catalog kernels may share one, `SHARED`)
built from its sources under `ops/csrc/`, compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into `horaedb_tpu_torch/_build/` (listed in .gitignore) and loaded with
ctypes. There is no `--use_fast_math`: the kernels must keep NaN
propagation and subnormals. The library name carries a hash of the sources
and flags, so an edited kernel never loads a stale build. Nothing here
runs at import: a CPU-only box imports every module.

`LAUNCHES` counts, per catalog name, the wrapper calls that launched the
kernel on the card (the plain CPU versions do not count).

A launch costs the host more than a small kernel costs the card, so the
path is lean: `kernel` binds an entry point's argtypes once and serves it
from a cache without the lock, and `launch` enters `torch.cuda.device` only
when the tensor's device is not the thread's current one.

A failed build or launch raises `KernelError`, its own class, so that a
caller that serves malformed input from another route (the encoded read
falls back to parquet on a corrupt sidecar) can let it through: a kernel
that does not build or launch is never hidden behind another route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from horaedb_tpu_torch.common.error import HoraeError

# catalog names are the JAX package's (`common/xprof.py` kernel names);
# each maps to its sources: every `.cu` is compiled into one library, the
# headers are hashed into its name (onesweep.cuh and compact.cuh wherever
# packedsort.cuh or keychain.cuh, which include them, is). The four decode
# kernels share bitunpack.cuh; keychain.cuh's chain of look-back sorts
# serves sort_perm, scan_kernel and the index merges; packedsort.cuh's
# merge by one packed key serves packed_merge and sample_sort_merge.
# predicate.cu is kernel E, which runs inside index_merge_filter and
# scan_kernel and is not a catalog kernel of its own. downsample and
# stacked_downsample compute their cell ids in grouped_stats' key pass:
# each loads that library (SHARED), and a call counts once under its own
# name and once under grouped_stats.
# multisegment_downsample is sharded_downsample's slot pass with a
# per-segment t0: it loads that library (SHARED) and counts its launches
# under its own name. The slot pass folds through segreduce.cuh and sorts
# unsorted rows through onesweep.cuh.
KERNELS = ("sort_perm", "block_sum_count", "block_min_max", "packed_merge",
           "index_merge_mask", "index_merge_filter", "scan_kernel", "downsample",
           "grouped_stats", "decode_unpack", "decode_dod", "decode_xor", "decode_rle",
           "stacked_downsample", "lane_sum_count", "segment_last_value",
           "sample_sort_merge", "grid_fold", "sharded_downsample", "multisegment_downsample")
SOURCES = {
    "sort_perm": ("sort_perm.cu", "keychain.cuh", "onesweep.cuh"),
    "block_sum_count": ("block_sum_count.cu", "segreduce.cuh"),
    "block_min_max": ("block_min_max.cu", "segreduce.cuh"),
    "packed_merge": ("packed_merge.cu", "packedsort.cuh", "onesweep.cuh", "compact.cuh"),
    "index_merge_mask": ("index_merge.cu", "keychain.cuh", "onesweep.cuh", "compact.cuh"),
    "index_merge_filter": ("index_merge.cu", "predicate.cu", "keychain.cuh", "onesweep.cuh",
                           "compact.cuh"),
    "scan_kernel": ("scan.cu", "predicate.cu", "keychain.cuh", "onesweep.cuh", "compact.cuh"),
    "grouped_stats": ("grouped_stats.cu", "onesweep.cuh", "segreduce.cuh"),
    "decode_unpack": ("decode_unpack.cu", "bitunpack.cuh"),
    "decode_dod": ("decode_dod.cu", "bitunpack.cuh"),
    "decode_xor": ("decode_xor.cu", "bitunpack.cuh"),
    "decode_rle": ("decode_rle.cu", "bitunpack.cuh"),
    "lane_sum_count": ("lane_sum_count.cu",),
    "segment_last_value": ("segment_last_value.cu",),
    "sample_sort_merge": ("sample_sort_merge.cu", "packedsort.cuh", "onesweep.cuh",
                          "compact.cuh"),
    "grid_fold": ("grid_fold.cu",),
    "sharded_downsample": ("sharded_downsample.cu", "predicate.cu", "onesweep.cuh",
                           "segreduce.cuh"),
}
SHARED = {"downsample": "grouped_stats", "stacked_downsample": "grouped_stats",
          "multisegment_downsample": "sharded_downsample"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

LAUNCHES = {name: 0 for name in KERNELS}

class KernelError(HoraeError):
    """A kernel did not build, load or launch."""


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_of(name: str) -> str:
    """The library that holds catalog kernel `name`."""
    return SHARED.get(name, name)


def _lib_path(name: str) -> Path:
    name = library_of(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc_cmd(name: str, out: Path) -> list[str]:
    units = [str(CSRC / src) for src in SOURCES[library_of(name)] if src.endswith(".cu")]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), *units]


def build_all(names=tuple(SOURCES)) -> dict[str, float]:
    """Compile every library of the kernels in `names` that has no current
    build, one nvcc process per library, all started together. Returns
    seconds per built library (0.0 for one already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    started = time.perf_counter()
    names = tuple(dict.fromkeys(library_of(n) for n in names))
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    took = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - started
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    if errors:
        raise KernelError("kernel build failed:\n" + "\n".join(errors))
    return took


def kernel(name: str, fn_name: str, argtypes: list, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point `fn_name` of kernel `name`, built on first use and
    bound to `argtypes`/`restype` once; later lookups return the cached
    entry without taking the lock. Every launch entry point returns
    cudaGetLastError() as an int; each library also exports the size of
    the scratch its launch needs."""
    key = (library_of(name), fn_name)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get(key)
        if fn is None:
            lib = _libs.get(key[0])
            if lib is None:
                build_all((key[0],))
                lib = _libs[key[0]] = ctypes.CDLL(str(_lib_path(key[0])))
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
            _fns[key] = fn
    return fn


def launch(name: str, fn: ctypes._CFuncPtr, dev: torch.device, *args) -> None:
    """Call launch entry point `fn(*args, stream)` with `dev`'s current
    stream and `dev` current (the runtime launches on the current device
    and refuses a stream of another one), then `check`. Enters
    `torch.cuda.device` only when `dev` is not the thread's current device.
    The stream handle comes from `torch._C._cuda_getCurrentRawStream` (the
    call PyTorch's own Triton launcher makes): `torch.cuda.current_stream`
    builds a Stream object first, 4-6 us of host time a launch on an H100's
    host (chip_ab.py launch, `host_parts_us`)."""
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    check(name, rc)


def scratch_bytes(name: str, fn_name: str, n: int) -> int:
    """Bytes of scratch kernel `name` needs for `n` rows, as its library
    computes them from its own tile size."""
    return kernel(name, fn_name, [ctypes.c_int64], ctypes.c_int64)(n)


def check(name: str, rc: int) -> None:
    """Raise on a failed launch, else count it."""
    if rc != 0:
        raise KernelError(f"{name}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[name] += 1
