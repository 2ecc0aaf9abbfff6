"""Observability (PyTorch port of RenderStats and log_json from
smallpt_tpu/utils/metrics.py): the reference's stderr telemetry
(smallpt.cpp:366-373) as data, and one-line JSON logging.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time


@dataclasses.dataclass
class RenderStats:
    """Accumulated render statistics (smallpt.cpp:366-373, as data)."""

    passes: int = 0
    rays: int = 0
    wall_s: float = 0.0

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.wall_s if self.wall_s > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "passes": self.passes,
            "rays": self.rays,
            "wall_s": round(self.wall_s, 4),
            "rays_per_s": round(self.rays_per_s),
        }


def log_json(event: str, payload: dict, stream=None) -> None:
    """One structured JSON log line (replaces fprintf(stderr, ...) telemetry)."""
    stream = stream or sys.stderr
    print(json.dumps({"event": event, "t": time.time(), **payload}),
          file=stream, flush=True)
