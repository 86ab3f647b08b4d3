#!/usr/bin/env python3
"""
Same-call A/B of the aligner kernel: this checkout's against another
checkout's, each launched through its own tree's wrapper
(cutadapt_tpu_torch/ops/align_cuda.py), so that each wrapper matches its
own kernel's C interface.

    python3 kernel_ab.py OTHER_TREE

OTHER_TREE is a checkout of the repository, for example an earlier commit
unpacked with ``git archive <commit> | tar -x -C _archive/parent``; its
kernel library is built with nvcc under that tree. On one NVIDIA GPU the
script

1. records the aligner's inputs at the flagship path's launch shapes: one
   chunk of 131,072 flagship reads (one 32768-row and two 4096-row launches
   of the 2-bit lane) and one chunk of the dirty lane (5% of the reads
   carry N: the 4-bit lane), through BatchPipelineEngine on the card;
2. checks that both kernels give the same packed words, every field of
   every read, on those inputs and on chip_smoke.py's parity matrix in
   both lanes;
3. times both at each recorded shape in turns (other, this, this, other),
   each turn the mean of 20 launches replayed from a CUDA graph;
4. prints the card's name and power limit, and one JSON line
   ``ab: {...}`` with each shape's times, turns and ratio, and each
   design's device time per chunk of the flagship and of the dirty lane.

Run from the repository root; it exits 2 without a card.
"""

import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 20


def load_wrapper(tree: str, alias: str):
    """The aligner wrapper module of the checkout at ``tree``, imported
    as the package ``alias`` so that it does not shadow this one's."""
    pkg = os.path.join(os.path.abspath(tree), "cutadapt_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(alias + ".ops.align_cuda")


def record_chunk(data: bytes):
    """The aligner's launches for one chunk through the engine on the
    card: a chip_smoke.Recorder of their shapes and first inputs."""
    import chip_smoke as cs
    import cutadapt_tpu_torch.batch_pipeline as bp
    import torch_fixtures as fx

    engine = fx.make_engine(device="cuda")
    engine.warmup(fx.READ_LEN)
    rec = cs.Recorder(bp.locate_packed)
    bp.locate_packed = rec
    try:
        for _ in bp.process_chunks_pipelined(engine, [data]):
            pass
    finally:
        bp.locate_packed = rec.fn
    return rec


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; the A/B "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import chip_smoke as cs
    import torch_fixtures as fx
    from cutadapt_tpu_torch.ops import align_cuda as this

    other = load_wrapper(sys.argv[1], "ab_other_tree")
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    designs = (("other", other.locate_packed), ("this", this.locate_packed))

    def run(which, enc, lens, tables, pack2):
        if which is other.locate_packed:
            tables = other.make_tables(tables.spec)
        return which(enc, lens, tables, pack2)

    main_rec = record_chunk(fx.make_dataset(fx.CHUNK_RECORDS))
    dirty_rec = record_chunk(fx.add_ns(
        fx.make_dataset(fx.CHUNK_RECORDS, seed=777), 0.05))
    recorded = []
    for cell, rec in (("flagship", main_rec), ("dirty", dirty_rec)):
        for key, (enc, lens, tables) in rec.inputs.items():
            recorded.append((cell, key, rec.calls.count(key), enc, lens,
                             tables))

    rng = np.random.RandomState(20260816)
    checked = 0
    inputs = [(enc, lens, tables, key[0])
              for _, key, _, enc, lens, tables in recorded]
    for L, B, spec, place in cs.parity_cases():
        tables = this.make_tables(spec)
        for pack2 in (True, False):
            _, enc, lens = fx.random_batch(spec, rng, B, L, pack2, **place)
            inputs.append((torch.from_numpy(enc).cuda(),
                           torch.from_numpy(lens).cuda(), tables, pack2))
    for enc, lens, tables, pack2 in inputs:
        a, b = (run(fn, enc, lens, tables, pack2) for _, fn in designs)
        if not torch.equal(a, b):
            print(f"kernel_ab: the two kernels differ on "
                  f"{int((a != b).any(0).sum())} reads (m={tables.m}, "
                  f"pack2={pack2}, shape {tuple(enc.shape)})",
                  file=sys.stderr)
            return 1
        checked += 1
    print(f"ab: both kernels give the same packed words on all {checked} "
          f"inputs", flush=True)

    rows = []
    per_chunk = {}
    for cell, key, calls, enc, lens, tables in recorded:
        order = (designs[0], designs[1], designs[1], designs[0])
        turns = [cs.cuda_ms(lambda: run(fn, enc, lens, tables, key[0]), REPS,
                            graph=True) for _, fn in order]
        other_ms, this_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        rows.append(dict(cell=cell, lane="2-bit" if key[0] else "4-bit",
                         shape=[key[1], key[2]], launches_per_chunk=calls,
                         other_ms=other_ms, this_ms=this_ms, turns_ms=turns,
                         speedup=other_ms / this_ms))
        chunk = per_chunk.setdefault(cell, {"other_ms": 0.0, "this_ms": 0.0})
        chunk["other_ms"] += calls * other_ms
        chunk["this_ms"] += calls * this_ms
    print("ab: " + json.dumps({"other": os.path.abspath(sys.argv[1]),
                               "shapes": rows, "per_chunk": per_chunk}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
