"""Serving tier switches of the port.

The JAX package's serving tier (compaction-time rollups, the result
cache, device block residency) is ON by default in its engine. The port
has none of its three layers yet: this module carries only the config,
the per-query switch and the honesty switch (`HORAEDB_SERVING=off`), so
that the port's `MetricEngine.open` can refuse an active tier with
`NotPortedError` instead of quietly serving cold.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


def serving_env_off() -> bool:
    """The honesty switch: HORAEDB_SERVING=off forces every query cold.
    Read per call, not at import, so tests and operators flip it live."""
    return os.environ.get("HORAEDB_SERVING", "").lower() in (
        "off", "0", "false", "no",
    )


@dataclass
class ServingTierConfig:
    """The serving tier's switch ([metric_engine.serving] `enabled` in
    TOML), ON by default as in the JAX package; the knobs of its layers
    wait for them."""

    enabled: bool = True


class ServingTier:
    """One engine's handle on the serving tier: here only its config."""

    def __init__(self, config: "ServingTierConfig | None" = None):
        self.config = config or ServingTierConfig()

    def active(self) -> bool:
        """Serving layers may be consulted (config on AND the
        HORAEDB_SERVING honesty switch not forcing cold)."""
        return self.config.enabled and not serving_env_off()
