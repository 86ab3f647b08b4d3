"""
The per-read processing pipeline: apply modifiers, then steps, until a
step consumes the read (pair).

One generic driver handles both arities: each iteration builds the
records tuple plus one ModificationInfo per record and threads
``(*records, *infos)`` through every stage — single-end stages receive
``(read, info)``, paired stages ``(read1, read2, info1, info2)``. The
batch engine replaces this loop with whole-chunk window updates
(batch_pipeline.py); accel.py decides per run which engine executes.

Reference parity: pipeline.py:23-153 of cutadapt:src/cutadapt.
"""

import logging
from abc import ABC
from typing import List, Optional, Tuple, Union

from .info import ModificationInfo
from .io.files import InputFiles
from .modifiers import (
    PairedEndModifier,
    PairedEndModifierWrapper,
    SingleEndModifier,
)
from .steps import SingleEndStep
from .utils import Progress

logger = logging.getLogger()

_PROGRESS_EVERY = 10000


class Pipeline(ABC):
    """Stream reads from input through modifiers and steps."""

    paired: bool

    _modifiers: list
    _steps: list

    def process_reads(
        self,
        infiles: InputFiles,
        progress: Optional[Progress] = None,
    ) -> Tuple[int, int, Optional[int]]:
        """Run the pipeline over all input reads.

        Returns (n_reads, total_bp_r1, total_bp_r2-or-None)."""
        reader = infiles.open()
        for i, step in enumerate(self._steps, 1):
            logger.debug("Pipeline step %d: %s", i, step)

        stages = self._modifiers + self._steps
        arity = 2 if self.paired else 1
        n = 0
        bp = [0, 0]
        for item in reader:
            n += 1
            if progress is not None and n % _PROGRESS_EVERY == 0:
                progress.update(_PROGRESS_EVERY)
            records = item if self.paired else (item,)
            infos = tuple(ModificationInfo(r) for r in records)
            for side in range(arity):
                bp[side] += len(records[side])
            for stage in stages:
                result = stage(*records, *infos)
                if result is None:
                    break
                records = result if self.paired else (result,)
        if progress is not None:
            progress.update(n % _PROGRESS_EVERY)
        infiles.close()
        return (n, bp[0], bp[1] if self.paired else None)


class SingleEndPipeline(Pipeline):
    paired = False

    def __init__(
        self,
        modifiers: List[SingleEndModifier],
        steps: List[SingleEndStep],
    ):
        self._modifiers = list(modifiers)
        self._steps = list(steps)


class PairedEndPipeline(Pipeline):
    paired = True

    def __init__(
        self,
        modifiers: List[
            Union[
                PairedEndModifier,
                Tuple[Optional[SingleEndModifier], Optional[SingleEndModifier]],
            ]
        ],
        steps,
    ):
        # whether the discard-untrimmed filter ignores pair_filter mode
        self.override_untrimmed_pair_filter = False
        self._steps = list(steps)
        self._modifiers: List[PairedEndModifier] = []
        for modifier in modifiers:
            if isinstance(modifier, tuple):
                self._modifiers.append(PairedEndModifierWrapper(*modifier))
            else:
                self._modifiers.append(modifier)
