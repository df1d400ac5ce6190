"""Boundaries of the PyTorch/CUDA port (horaedb_tpu_torch).

- Nothing in the port, chip_smoke.py or chip_ab.py imports jax or
  the JAX package (the card's machine has no jax; it has pyarrow and
  protobuf, which the port's storage uses).
- The port's protobuf modules are byte-identical copies of the JAX
  package's, so one process can import both.
- Entry points default to the card and raise where there is none, instead
  of running on the CPU; the plain versions run only when asked for.
- The host copies (time_ext, size_ext) parse as the JAX package's do.
- The kernel build keeps the sm_90a target and no fast math.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from horaedb_tpu.common.size_ext import ReadableSize as JaxSize
from horaedb_tpu.common.time_ext import ReadableDuration as JaxDuration
from horaedb_tpu_torch import KERNELS, launch_counts
from horaedb_tpu_torch.common.error import HoraeError
from horaedb_tpu_torch.common.size_ext import ReadableSize
from horaedb_tpu_torch.common.time_ext import ReadableDuration
from horaedb_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "horaedb_tpu_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "horaedb_tpu")
SCHEMA = [("metric_id", np.uint64), ("tsid", np.uint64), ("field_id", np.uint64),
          ("ts", np.int64), ("value", np.float64)]


def _imported_modules(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append(node.module)
    return out


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py", "chip_ab.py"])
def test_no_forbidden_imports(rel):
    bad = [m for m in _imported_modules(ROOT / rel) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_forbidden_rule_catches_the_reference_but_not_the_port():
    assert _forbidden("horaedb_tpu.ops.sort") and _forbidden("jax.numpy")
    assert _forbidden("jaxlib.xla_client") and _forbidden("horaedb_tpu")
    assert not _forbidden("horaedb_tpu_torch.ops.sort") and not _forbidden("jaxtyping_like")
    assert not _forbidden("pyarrow") and not _forbidden("google.protobuf")


@pytest.mark.parametrize("rel", ["pb/sst_pb2.py", "pb/protos/sst.proto",
                                 "pb/remote_write_pb2.py", "pb/protos/remote_write.proto"])
def test_pb_copy_is_byte_identical(rel):
    port, reference = ROOT / "horaedb_tpu_torch" / rel, ROOT / "horaedb_tpu" / rel
    assert port.read_bytes() == reference.read_bytes()


def test_both_pb_copies_share_one_registration():
    from horaedb_tpu.pb import sst_pb2 as jax_pb
    from horaedb_tpu_torch.pb import sst_pb2 as port_pb

    msg = port_pb.ManifestUpdate(to_deletes=[2**64 - 1])
    assert jax_pb.ManifestUpdate.FromString(msg.SerializeToString()).to_deletes == [2**64 - 1]


def test_both_remote_write_copies_share_one_registration():
    from horaedb_tpu.pb import remote_write_pb2 as jax_pb
    from horaedb_tpu_torch.pb import remote_write_pb2 as port_pb

    msg = port_pb.WriteRequest()
    lab = msg.timeseries.add().labels.add()
    lab.name, lab.value = b"__name__", b"up"
    got = jax_pb.WriteRequest.FromString(msg.SerializeToString())
    assert got.timeseries[0].labels[0].value == b"up"
    assert port_pb.DESCRIPTOR is jax_pb.DESCRIPTOR or \
        port_pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a box without a CUDA device")


def _entry_points():
    import asyncio

    import pyarrow as pa

    from horaedb_tpu_torch.engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemStore
    from horaedb_tpu_torch.ops.aggregate import downsample_sorted
    from horaedb_tpu_torch.serving import ServingTierConfig
    from horaedb_tpu_torch.ops.decode import decode_page_device
    from horaedb_tpu_torch.ops.sort import sort_permutation
    from horaedb_tpu_torch.storage import ObjectBasedStorage
    from horaedb_tpu_torch.storage.carry import open_local_root
    from horaedb_tpu_torch import entry
    from horaedb_tpu_torch.engine.region import RegionedEngine
    from horaedb_tpu_torch.parallel import make_mesh

    schema = pa.schema([(n, pa.from_numpy_dtype(dt)) for n, dt in SCHEMA])
    z = np.zeros(4, np.int64)
    return {
        "try_new": lambda: asyncio.run(ObjectBasedStorage.try_new(
            "db", MemStore(), schema, 4, 7_200_000, enable_compaction_scheduler=False,
            start_background_merger=False)),
        "open_local_root": lambda: asyncio.run(open_local_root(
            str(ROOT / "chiprun_out" / "never-created"), "db", schema, 4, 7_200_000)),
        "sort_permutation": lambda: sort_permutation([np.arange(4, dtype=np.uint64)]),
        "downsample_sorted": lambda: downsample_sorted(z, z.astype(np.int32), z * 1.0, 0, 10,
                                                       num_series=1, num_buckets=1),
        "decode_page_device": lambda: decode_page_device("dod", "<i8", b"", 2, 0, 5, 1, None),
        "MetricEngine.open": lambda: asyncio.run(MetricEngine.open(
            "db", MemStore(), enable_compaction=False,
            serving=ServingTierConfig(enabled=False))),
        "make_mesh": lambda: make_mesh(4, series_parallel=2),
        "RegionedEngine.open": lambda: asyncio.run(RegionedEngine.open(
            "db", MemStore(), 4, enable_compaction=False,
            serving=ServingTierConfig(enabled=False))),
        "entry": lambda: entry.entry(),
        "dryrun_multichip": lambda: entry.dryrun_multichip(4),
    }


@pytest.mark.parametrize("name", ["try_new", "open_local_root", "sort_permutation",
                                  "downsample_sorted", "decode_page_device",
                                  "MetricEngine.open", "make_mesh", "RegionedEngine.open",
                                  "entry", "dryrun_multichip"])
def test_entry_point_without_device_raises_on_cpu_box(no_card, name):
    with pytest.raises(HoraeError, match="no CUDA device"):
        _entry_points()[name]()


def test_plain_versions_do_not_count_launches():
    from horaedb_tpu_torch.ops import aggregate, decode, merge, scan
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.ops.blockagg import sorted_segment_min_max, sorted_segment_sum_count
    from horaedb_tpu_torch.ops.sort import sort_permutation

    before = launch_counts()
    k = torch.zeros(3, dtype=torch.int32)
    v = torch.ones(3, dtype=torch.float64)
    sorted_segment_sum_count(k, v, 1)
    sorted_segment_min_max(k, v, 1)
    sort_permutation([np.array([3, 1, 2], np.uint64)], device="cpu")
    key = torch.tensor([5, 1, 5], dtype=torch.int64)
    merge.packed_merge(key, 3, 1, True)
    merge.index_merge_mask([key], [(1, 5)], 1, torch.ones(3, dtype=torch.uint8), True, False)
    prog = F.compile_program(F.Compare("k", "gt", 1), {"k": np.dtype(np.int64)})
    merge.index_merge_filter([key], [(1, 5)], 1, prog, {"k": key}, 3, True, False, "cpu")
    scan.scan_kernel({"k": key}, [key], [(1, 5)], 1, prog, 3, True, False, "cpu")
    aggregate.grouped_stats(v, k, None, 2)
    aggregate.downsample(key, k, v, None, 0, 2, 1, 4)
    words = torch.tensor([0x55, 0], dtype=torch.int32)
    table = torch.tensor([[0, 3, 0, 1, 0, 0]], dtype=torch.int64)
    decode.decode_unpack(words, table, torch.tensor([7, 9]), 3)
    decode.decode_dod(words, table, 3, 8)
    decode.decode_xor(words, table, 3, 4)
    decode.decode_rle(torch.tensor([7, 3, 0], dtype=torch.int32),
                      torch.tensor([[0, 3, 0, 0, 1, 0]]), 3, 4)
    aggregate.stacked_downsample(key[None], k[None], v[None], torch.ones(1, 3, dtype=torch.bool),
                                 torch.zeros(1, dtype=torch.int64), 2, 1, 4)
    aggregate.lane_segment_sum_count(k, v, 2)
    aggregate.segment_last_value(v, key, k, torch.ones(3, dtype=torch.bool), 2)
    from horaedb_tpu_torch.ops import mesh as mesh_ops

    grids = {name: torch.zeros(2, 3, dtype=torch.float64) for name in mesh_ops.FOLD_KEYS}
    mesh_ops.grid_fold(grids)
    for library, sorted_input in (("sharded_downsample", True),
                                  ("multisegment_downsample", False)):
        mesh_ops.slot_grids(key, k, v, torch.ones(3, dtype=torch.bool), None, 0, 2, 0, 1, 4,
                            sorted_input, library=library)
    send_k, send_i = mesh_ops.ssm_local(key, 3, 1, torch.zeros(1, dtype=torch.int64), 2, 4, 0)
    mesh_ops.ssm_merge(send_k, send_i, 3, 1, True)
    assert launch_counts() == before
    assert set(before) == set(KERNELS) == {"sort_perm", "block_sum_count", "block_min_max",
                                           "packed_merge", "index_merge_mask",
                                           "index_merge_filter", "scan_kernel", "downsample",
                                           "grouped_stats", "decode_unpack", "decode_dod",
                                           "decode_xor", "decode_rle", "stacked_downsample",
                                           "lane_sum_count", "segment_last_value",
                                           "sample_sort_merge", "grid_fold",
                                           "sharded_downsample", "multisegment_downsample"}


@pytest.mark.parametrize("text", ["0", "1500", "2h", "1d2h3m4s5ms", "1.5h", "90s", "250ms"])
def test_duration_copy_parses_as_reference(text):
    ours, ref = ReadableDuration.parse(text), JaxDuration.parse(text)
    assert ours.ms == ref.ms and str(ours) == str(ref)


@pytest.mark.parametrize("text", ["2GiB", "512MiB", "0.5e6 B", "4KB", "123"])
def test_size_copy_parses_as_reference(text):
    ours, ref = ReadableSize.parse(text), JaxSize.parse(text)
    assert ours.bytes == ref.bytes and str(ours) == str(ref)


def test_multisegment_downsample_shares_the_sharded_library():
    """Rows 16 and 17 are one slot pass: one library, built once, and
    every catalog name is a library or shares one."""
    assert _build._lib_path("multisegment_downsample") == _build._lib_path("sharded_downsample")
    assert set(_build.SOURCES).isdisjoint(_build.SHARED)
    assert set(_build.SOURCES) | set(_build.SHARED) == set(KERNELS)


def test_downsample_computes_its_cells_in_the_grouped_stats_library():
    """Row 8's cell ids come from grouped_stats' key pass: one library, the
    look-back sort's header among its sources and radix.cuh not."""
    assert _build._lib_path("downsample") == _build._lib_path("grouped_stats")
    sources = _build.SOURCES[_build.library_of("downsample")]
    assert "onesweep.cuh" in sources and "radix.cuh" not in sources
    assert not (_build.CSRC / "downsample.cu").exists()


def test_stacked_downsample_computes_its_cells_in_the_grouped_stats_library():
    """Row 7's cell ids come from grouped_stats' key pass too: no library of
    its own, no source that writes an id lane."""
    assert _build._lib_path("stacked_downsample") == _build._lib_path("grouped_stats")
    assert "stacked_downsample" not in _build.SOURCES
    assert not (_build.CSRC / "stacked_downsample.cu").exists()
    assert "grouped_stats_stacked_launch" in (_build.CSRC / "grouped_stats.cu").read_text()


@pytest.mark.parametrize("name", ["index_merge_mask", "index_merge_filter", "sample_sort_merge",
                                  "scan_kernel", "sort_perm", "packed_merge"])
def test_merges_sort_through_the_look_back_header(name):
    """Rows 19, 20, 14, 21, 4 and 18 sort through onesweep.cuh, the chains
    of packed keys through keychain.cuh and the merges of one packed key
    through packedsort.cuh: each header is among the sources of the
    libraries that use it, and radix.cuh, the single-block digit-count sort
    they replaced, is in no source list and not in the tree."""
    sources = _build.SOURCES[_build.library_of(name)]
    assert "onesweep.cuh" in sources
    for header in ("keychain.cuh", "packedsort.cuh"):
        assert "onesweep::sort(" in (_build.CSRC / header).read_text()
    for src in (s for s in sources if s.endswith(".cu")):
        text = (_build.CSRC / src).read_text()
        assert ("onesweep::sort(" in text or src == "predicate.cu"
                or "keychain::sort(" in text and "keychain.cuh" in sources
                or "packedsort::" in text and "packedsort.cuh" in sources)
        assert "radix" not in re.sub(r"//.*", "", text)
    assert not (_build.CSRC / "radix.cuh").exists()
    assert all("radix.cuh" not in srcs for srcs in _build.SOURCES.values())


@pytest.mark.parametrize("name", KERNELS)
def test_build_command_targets_sm90a_without_fast_math(name, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build._nvcc_cmd(name, Path("/dev/null"))
    joined = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in joined
    assert "fast_math" not in joined and "fast-math" not in joined
    sources = _build.SOURCES[_build.library_of(name)]
    for src in sources:
        assert (_build.CSRC / src).exists()
        assert (str(_build.CSRC / src) in cmd) == src.endswith(".cu")
    assert ("predicate.cu" in sources) == (name in (
        "index_merge_filter", "scan_kernel", "sharded_downsample", "multisegment_downsample"))
    assert _build._lib_path(name).parent == ROOT / "horaedb_tpu_torch" / "_build"
