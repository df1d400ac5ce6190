"""Load stored state written elsewhere into the port's store.

For this database the stored runs take the place a model's weights have:
`runs_from_reference` takes SSTs as plain numpy lanes, as the JAX
package's `read_sst` returns them, and seals each as a run with the same
id, sequence and time range, so both packages can answer queries over the
same data.
"""

from __future__ import annotations

import numpy as np

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.storage.sst import SstFile
from horaedb_tpu_torch.storage.types import SEQ_COLUMN_NAME, TimeRange


def runs_from_reference(storage, segments) -> list[SstFile]:
    """`segments`: iterable (one entry per segment) of iterables of SSTs,
    each a dict with `id`, `time_range` as (start, end) and `lanes`: every
    schema column (pk lanes, ts, value, `__seq__`) as a pk-sorted numpy
    lane. Returns the handles of the sealed runs."""
    out = []
    names = storage.schema.names
    dtypes = dict(storage.schema.columns)
    for seg in segments:
        for sst in seg:
            lanes = {}
            for name in names:
                ensure(name in sst["lanes"], f"sst {sst['id']}: missing lane {name!r}")
                lanes[name] = np.ascontiguousarray(sst["lanes"][name], dtype=dtypes[name])
            seqs = lanes[SEQ_COLUMN_NAME]
            seq = int(seqs.max()) if len(seqs) else int(sst["id"])
            start, end = sst["time_range"]
            out.append(storage.add_run(int(sst["id"]), seq, TimeRange(int(start), int(end)),
                                       lanes))
    return out
