"""The refresh's stages in a traced window. The program launches an empty
kernel named boot_mark_<stage> where each stage of a refresh begins on the
device, and boot_mark_done where the last ends (csrc/marker.cu; a CUDA
graph replays them with the stage), so the device activities between two
markers, in start order on the one stream, are the first marker's stage.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, Optional, Tuple

MARK = re.compile(r"boot_mark_([a-z0-9_]+)")


def is_marker(name: str) -> bool:
    return MARK.search(name) is not None


def stage_seconds(traced) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(device seconds by stage, markers by stage) of a traced window: the
    activities after each marker up to the next, by the marker's stage;
    those after a `done` marker (or before the first marker) belong to no
    stage."""
    out: Dict[str, float] = collections.defaultdict(float)
    marks: Dict[str, int] = collections.Counter()
    stage = None
    for start, stop, name in traced.spans:
        m = MARK.search(name)
        if m:
            stage = m.group(1)
            marks[stage] += 1
        elif stage is not None and stage != "done":
            out[stage] += (stop - start) / 1e6
    return dict(out), dict(marks)


def per_refresh_ms(r, *stages: str) -> Optional[float]:
    """Device ms a refresh in `stages` over a boot cell's traced window, or
    None where the window is another kind's, or the trace lost a marker
    (each refresh the window completed has one c2s, s2c and done marker and
    two evalmod markers)."""
    if r.mix.get("kind") != "ckks_boot" or not r.units:
        return None
    seconds, marks = stage_seconds(r.traced)
    want = {"c2s": r.units, "evalmod": 2 * r.units, "s2c": r.units, "done": r.units}
    if any(marks.get(k, 0) != v for k, v in want.items()):
        return None
    return 1e3 * sum(seconds.get(s, 0.0) for s in stages) / r.units
