"""The mesh execution layer: construction helpers and the one mesh-scan
entry every engine path shares.

A port of the JAX package's `parallel/mesh.py`. Axis conventions are the
same:
- "rows":   data parallelism over row blocks; the partial grids of the
            row shards combine (psum/pmin/pmax in the JAX package);
- "series": output-grid sharding over series space; results stay sliced
            along it until the caller gathers them.

The port has no `shard_map`: a `Mesh` is a numpy array of slots, each
holding a `torch.device`, and the host drives one call per slot
(`parallel/scan.py`, `parallel/merge.py`). Several slots may hold the
same device, as the JAX tests put 8 virtual CPU devices on one host: one
H100 carries a 4- or 8-slot mesh, every slot on `cuda:0`. A slot on
another card is reached with a peer copy (`Tensor.to`); NCCL and several
processes are later work.

Dtype: the JAX package accumulates the mesh path in f32 on accelerators
(`horaedb_tpu/parallel/mesh.py:113-118`); the port keeps f64 on the card,
as every other port path does, so the mesh route agrees with the
single-device route within rtol 1e-12 (the grid fold itself is bitwise).
"""

from __future__ import annotations

import numpy as np
import torch

from horaedb_tpu_torch.backend import DEFAULT_DEVICE, resolve_device
from horaedb_tpu_torch.common.error import ensure


class Mesh:
    """A grid of slots with axis names: `devices` is a numpy object array
    of `torch.device`s (one per slot), `shape` maps each axis name to its
    size, `size` counts the slots. Hashable by its slots and names, so
    the layers above can memoize on it."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        arr = np.asarray(devices, dtype=object)
        arr = np.array([torch.device(d) for d in arr.flat], dtype=object).reshape(arr.shape)
        ensure(arr.ndim == len(axis_names),
               f"mesh of rank {arr.ndim} needs {arr.ndim} axis names, got {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.size = int(arr.size)

    def _key(self):
        return (tuple(str(d) for d in self.devices.reshape(-1)), self.devices.shape,
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


# Ambient mesh: the storage paths dispatch through the sharded steps
# whenever an active mesh of more than one slot is installed; the
# single-device paths stay the default.
_ACTIVE: Mesh | None = None


def set_active_mesh(mesh: "Mesh | None") -> None:
    global _ACTIVE
    _ACTIVE = mesh


def active_mesh() -> "Mesh | None":
    """The installed mesh, or None when absent or degenerate (size 1)."""
    if _ACTIVE is None or _ACTIVE.size <= 1:
        return None
    return _ACTIVE


def mesh_devices(n: int | None = None, device=DEFAULT_DEVICE) -> list[torch.device]:
    """The cards of this machine (`device` "cuda", the default, which raises
    where there is none) or the CPU, one slot each; the first `n`."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        devs = [torch.device("cpu")]
    else:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n is None:
        return devs
    ensure(n <= len(devs), f"requested {n} devices, have {len(devs)}")
    return devs[:n]


def make_mesh(
    n_devices: int | None = None,
    series_parallel: int = 1,
    axis_names: tuple[str, str] = ("rows", "series"),
    devices: "list | None" = None,
) -> Mesh:
    """Build a 2-D (rows x series) mesh over `devices`, or over the first
    `n_devices` cards when no list is given.

    `devices` is an explicit slot list, as `jax.sharding.Mesh(np.array(
    devices), names)` takes one; it may repeat a device. A list that names
    one card n times is the counterpart of the JAX tests' n virtual CPU
    devices: one H100 carries the whole mesh. `series_parallel` slots shard
    the series dimension; the rest data-parallel the rows."""
    if devices is None:
        devs = mesh_devices(n_devices)
    else:
        devs = [resolve_device(d) for d in devices]
        ensure(n_devices is None or n_devices == len(devs),
               f"n_devices={n_devices} but {len(devs)} devices given")
    n = len(devs)
    ensure(n % series_parallel == 0,
           f"{n} devices not divisible by series_parallel={series_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n // series_parallel, series_parallel), axis_names)


def mesh_downsample(
    mesh: Mesh,
    ts_np,
    sid_np,
    val_np,
    t0,
    bucket_ms,
    num_series: int,
    num_buckets: int,
    with_minmax: bool = True,
    valid_np=None,
    sorted_input: bool = True,
) -> dict:
    """One run reduced over the mesh: rows shard over "rows" (the grid fold
    combines the partial grids), the output grid shards over "series"
    (padded up to the axis size, trimmed on the way back). `valid_np`
    excludes rows through the weight column; their sid must stay monotone
    when `sorted_input`. Returns host grids of sum, count (and min, max).

    Row padding is per lane: the sid lane pads with `padded_series` (out of
    every slot's series slice, so pad rows land on the sentinel key and
    stay contiguous at the sorted tail) and the validity lane pads False,
    so a pad row never perturbs a partial, whatever the series count's
    divisibility. Values stay f64 (the module's dtype rule)."""
    from horaedb_tpu_torch.parallel.scan import shard_rows, sharded_downsample

    series_par = mesh.shape["series"]
    padded_series = num_series + (-num_series % series_par)
    n = len(ts_np)
    lanes = (
        np.asarray(ts_np, dtype=np.int64),
        np.asarray(sid_np, dtype=np.int32),
        np.asarray(val_np, dtype=np.float64),
        np.ones(n, dtype=bool) if valid_np is None else np.asarray(valid_np, dtype=bool),
    )
    (ts_d, sid_d, val_d, ok_d), _pad_valid = shard_rows(
        mesh, lanes, pad_value=(0, padded_series, 0, False))
    # pad rows carry ok=False, so ok_d alone is the full validity mask
    out = sharded_downsample(
        mesh, ts_d, sid_d, val_d, ok_d,
        t0=t0, bucket_ms=bucket_ms,
        num_series=padded_series, num_buckets=num_buckets,
        with_minmax=with_minmax, sorted_input=sorted_input,
    )
    return {
        k: v.cpu().numpy()[:num_series]
        for k, v in out.items()
        if k in ("sum", "count", "min", "max")
    }
