"""Cross-slot sorted merge (a distributed sample sort) and the cross-slot
partial-grid fold.

A port of the JAX package's `parallel/merge.py`. The sample sort, over
every slot of the mesh on one axis:

1. rows shard over the slots in natural order;
2. each slot sorts its shard (kernel `sample_sort_merge`, local step);
3. D-1 group-granular splitters, computed on the host from a stride
   sample, partition the key space into D pk-disjoint ranges (a dedup
   group never spans two slots, so keep-last stays local);
4. the exchange: slot e gathers range e of every slot, in slot order (the
   JAX package's `all_to_all`; here device copies on one card, peer copies
   between cards);
5. each slot merges its runs and keeps the last row of each group (merge
   step);
6. slot outputs are pk-disjoint and sorted, so the result is their
   concatenation in slot order.

Skew: the host computes the exact per-(slot, bucket) counts before any
launch, so the bucket capacity cannot overflow; an adversarial key
distribution (all-equal pks included) makes one busy slot, never a wrong
result. The output row indices equal kernel D's (`packed_merge`)
bytewise, ties on the packed key resolved by global row order.

Keys are u64 on the host, as in the JAX package, and cross to the card
mapped to int64 (`backend.u64_to_i64`); the splitters, counts and capacity
are computed on the raw u64 keys, exactly as the JAX package computes
them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from horaedb_tpu_torch.backend import to_device, u64_to_i64
from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.ops import mesh as mesh_ops
from horaedb_tpu_torch.ops.blocks import PACK_SENTINEL as _SENTINEL
from horaedb_tpu_torch.parallel.mesh import Mesh

MERGE_AXIS = "merge"
# Pad granules: the shard length and the bucket capacity round up to these
# (the JAX package's, which bound its jit cache; kept for equal layouts)
_LOCAL_GRANULE = 8192
_CAP_GRANULE = 1024


@lru_cache(maxsize=8)
def _merge_mesh_for(devices: tuple) -> Mesh:
    """A 1-D mesh over the given slots (the scan mesh is 2-D rows x
    series; the merge wants every slot on one axis)."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr, (MERGE_AXIS,))


def merge_mesh(mesh: Mesh) -> Mesh:
    return _merge_mesh_for(tuple(str(d) for d in mesh.devices.reshape(-1)))


def _splitters_from_sample(
    grp: np.ndarray, valid: np.ndarray, D: int, oversample: int = 64
) -> np.ndarray:
    """D-1 group-id splitters from an evenly-strided sample of valid rows.
    Splitter quality only affects load balance, never correctness (the
    exact capacity is computed from the real distribution)."""
    vi = np.nonzero(valid)[0]
    if len(vi) == 0:
        return np.zeros(D - 1, np.uint64)
    want = min(len(vi), D * oversample)
    sample = np.sort(grp[vi[np.linspace(0, len(vi) - 1, want).astype(np.int64)]])
    qs = (np.arange(1, D) * len(sample)) // D
    return sample[qs].astype(np.uint64)


class SamplePlan:
    """The host half of one sharded merge: the slots, the shard length, the
    splitters, the exact capacity and the slots' key shards on their
    devices. `run(plain)` is the device half."""

    def __init__(self, packed: np.ndarray, seq_width: int, do_dedup: bool, mesh: Mesh,
                 key_bits: int | None = None):
        n = len(packed)
        mesh1d = merge_mesh(mesh)
        self.slots = list(mesh1d.devices.reshape(-1))
        D = self.d_slots = mesh1d.size
        local_n = -(-n // D)
        local_n = ((local_n + _LOCAL_GRANULE - 1) // _LOCAL_GRANULE) * _LOCAL_GRANULE
        padded = local_n * D
        ensure(padded < (1 << 31), "sharded merge carries int32 row ids")
        if padded != n:
            packed = np.concatenate([packed, np.full(padded - n, _SENTINEL, np.uint64)])
        grp = packed >> np.uint64(seq_width)
        valid = packed != _SENTINEL
        splitters = _splitters_from_sample(grp, valid, D)
        # exact per-(shard, bucket) counts -> a capacity that cannot overflow
        bucket = np.searchsorted(splitters, grp, side="right")
        shard = np.arange(padded, dtype=np.int64) // local_n
        counts = np.bincount(shard * D + bucket, minlength=D * D)
        cap = int(counts.max())
        self.cap = max(_CAP_GRANULE, ((cap + _CAP_GRANULE - 1) // _CAP_GRANULE) * _CAP_GRANULE)
        if key_bits is None:
            top = int(packed[valid].max()) if valid.any() else 1
            key_bits = max(1, top.bit_length())
        self.key_bits = key_bits
        self.seq_width = seq_width
        self.do_dedup = do_dedup
        self.local_n = local_n
        self.splitters = splitters
        mapped = u64_to_i64(packed)
        sp = splitters.view(np.int64)
        self.keys = [to_device(mapped[d * local_n:(d + 1) * local_n], dev)
                     for d, dev in enumerate(self.slots)]
        self.splitter_lanes = [to_device(sp, dev) for dev in self.slots]

    def run(self, plain: bool = False):
        """Launch both steps on every slot; returns the per-slot (row ids,
        count) tensors, nothing synchronised. `plain` runs the plain
        versions on the slots' devices."""
        D, cap = self.d_slots, self.cap
        local = mesh_ops.ssm_local_plain if plain else mesh_ops.ssm_local
        merge = mesh_ops.ssm_merge_plain if plain else mesh_ops.ssm_merge
        sends = [local(self.keys[d], self.key_bits, self.seq_width, self.splitter_lanes[d], D,
                       cap, d * self.local_n) for d in range(D)]
        outs = []
        for e, dev in enumerate(self.slots):
            # the exchange: lane e of every slot, in slot order
            recv_k = torch.cat([k[e * cap:(e + 1) * cap].to(dev) for k, _ in sends])
            recv_i = torch.cat([i[e * cap:(e + 1) * cap].to(dev) for _, i in sends])
            outs.append(merge(recv_k, recv_i, self.key_bits, self.seq_width, self.do_dedup))
        return outs


def _collect(outs) -> np.ndarray:
    counts = [int(c.item()) for _, c in outs]
    parts = [o[:k].cpu().numpy() for (o, _), k in zip(outs, counts) if k]
    if not parts:
        return np.empty(0, np.int64)
    return np.concatenate(parts).astype(np.int64)


def sharded_packed_merge(
    packed: np.ndarray,
    seq_width: int,
    do_dedup: bool,
    mesh: Mesh,
    defer: bool = False,
    key_bits: int | None = None,
):
    """Merge + dedup the packed-key rows across every slot of `mesh`.

    `packed`: u64 array, one 63-bit (pk..., seq-rank) key per row, rejected
    rows pre-sunk to the all-ones sentinel (the same host contract as
    kernel D). Returns the surviving row indices (into `packed`) in global
    sorted order, equal to kernel D's. `key_bits` bounds the valid keys'
    width (computed when None).

    `defer=True` returns a zero-argument collect closure instead: the steps
    are queued and the host synchronises only when the closure runs (the
    chunked scan's double-buffering contract)."""
    n = len(packed)
    if n == 0:
        empty = np.empty(0, np.int64)
        return (lambda: empty) if defer else empty
    plan = SamplePlan(np.asarray(packed, dtype=np.uint64), seq_width, do_dedup, mesh, key_bits)
    outs = plan.run()
    return (lambda: _collect(outs)) if defer else _collect(outs)


def sharded_packed_merge_plain(packed: np.ndarray, seq_width: int, do_dedup: bool,
                               mesh: Mesh) -> np.ndarray:
    """Plain version of `sharded_packed_merge`: the same plan, every step's
    plain version on the slots' devices."""
    if len(packed) == 0:
        return np.empty(0, np.int64)
    return _collect(SamplePlan(np.asarray(packed, dtype=np.uint64), seq_width, do_dedup,
                               mesh).run(plain=True))


# -- cross-slot partial-grid fold ------------------------------------------------
# The coordinator side of the distributed scatter-gather read
# (cluster/partial.py): k aligned per-region partial grids fold into one.
# Cells are independent, so the series axis shards over the merge mesh's
# slots and each slot folds its slice left over the k partials: the host
# numpy fold's per-cell order, which keeps the device route bitwise equal.

_FOLD_KEYS = ("sum", "count", "min", "max")


@lru_cache(maxsize=8)
def device_fold_safe(mesh: Mesh) -> bool:
    """Whether this mesh's slots keep f64 subnormals through the fold (the
    bitwise precondition). The probe folds one DAZ case (a subnormal input)
    and one FTZ case (normal inputs whose sum is subnormal) and compares
    bits against numpy; a flushing platform falls back to the host fold in
    cluster/partial.py `merge_grids`. The card's f64 arithmetic keeps
    subnormals and the build has no fast math, so it reads True there. A
    fold that fails to build or launch raises (`KernelError`): only the
    bits decide, so a broken kernel is never read as a flushing one."""
    k, s, b = 2, 2, 1
    stacked = {key: np.zeros((k, s, b)) for key in _FOLD_KEYS}
    stacked["min"][:] = np.inf
    stacked["max"][:] = -np.inf
    tiny = np.float64(2.0 ** -1022)
    stacked["sum"][0, 0, 0] = np.float64(5e-324)          # DAZ probe
    stacked["sum"][0, 1, 0] = tiny                        # FTZ probe:
    stacked["sum"][1, 1, 0] = -tiny * (1.0 - 2.0 ** -52)  # normal + normal
    got = sharded_grid_fold(mesh, stacked)["sum"]
    want = stacked["sum"][0] + stacked["sum"][1]
    return bool(np.array_equal(got.view(np.uint64), want.view(np.uint64)))


def sharded_grid_fold(mesh: Mesh, stacked: "dict[str, np.ndarray]") -> dict:
    """Fold k stacked partial grids ([k, S, B] per key, identity rows where
    a partial lacks a series) across every slot of `mesh` (kernel
    `grid_fold`, one launch a slot). Returns host {sum, count, min, max} of
    shape [S, B], bitwise equal to the sequential host fold. Callers that
    need the bitwise guarantee gate on `device_fold_safe(mesh)` first
    (cluster/partial.py does)."""
    k, S, n_buckets = stacked["sum"].shape
    if k == 0 or S == 0:
        return {key: np.asarray(v[0] if k else v.sum(0)) for key, v in stacked.items()}
    slots = list(merge_mesh(mesh).devices.reshape(-1))
    local_s = -(-S // len(slots))
    outs = []
    for d, dev in enumerate(slots):
        part = {}
        for key in _FOLD_KEYS:
            a = np.ascontiguousarray(stacked[key][:, d * local_s:(d + 1) * local_s])
            short = local_s - a.shape[1]
            if short:  # the last slot's pad rows hold the identity
                ident = {"min": np.inf, "max": -np.inf}.get(key, 0.0)
                a = np.concatenate([a, np.full((k, short, n_buckets), ident, a.dtype)], axis=1)
            part[key] = to_device(a.astype(np.float64, copy=False), dev)
        outs.append(mesh_ops.grid_fold(part))
    return {key: np.concatenate([o[key].cpu().numpy() for o in outs])[:S] for key in _FOLD_KEYS}
