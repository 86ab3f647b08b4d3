"""Per-read modification metadata passed between pipeline stages.

Batch analog: the engine keeps this information as per-read arrays
(match events, windows, rc mask) in batch_pipeline.py; this dataclass
is the per-read fallback form of the same record.

Reference parity: info.pyx:1-29 of cutadapt:src/cutadapt.
"""

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class ModificationInfo:
    """
    One instance accompanies each read through the pipeline, carrying
    whatever modifiers need to communicate to later modifiers and to
    the filters: adapter matches, the unmodified read, unconditionally
    removed prefix/suffix, and whether the read was reverse-complemented.
    """

    original_read: Any
    matches: List[Any] = field(default_factory=list)
    cut_prefix: Optional[str] = None
    cut_suffix: Optional[str] = None
    is_rc: Optional[bool] = None
