"""The roofline's frozen DP arithmetic against the port's own count
(ops/align_cuda.py:dp_work) and against padding."""

import numpy as np
import pytest

from benchmark import roofline


def tables_for(adapter, max_error_rate=0.1):
    from cutadapt_tpu_torch.ops.align_batch import AlignerSpec
    from cutadapt_tpu_torch.ops.align_cuda import make_tables

    spec = AlignerSpec(adapter, max_error_rate, flags=14, min_overlap=3)
    return make_tables(spec)


def work(enc, lens, tables, pack2):
    spec = tables.spec
    return roofline.launch_work(enc, lens, tables.table, tables.m, tables.k,
                                spec.start_in_query, spec.stop_in_query,
                                pack2, False)


@pytest.mark.parametrize("pack2, bits", [(True, 2), (False, 4)])
def test_operations_are_the_ports_count(pack2, bits):
    from cutadapt_tpu_torch.ops.align_cuda import dp_work

    tables = tables_for("AGATCGGAAGAGCACACGTCTGAACTCCAGTCA")
    rng = np.random.default_rng(1)
    width = 100 * bits // 8
    enc = rng.integers(0, 256, (500, width), dtype=np.uint8)
    lens = rng.integers(1, 101, 500)
    assert work(enc, lens, tables, pack2)[0] == dp_work(enc, lens, tables,
                                                        pack2)[3]


def test_padding_adds_nothing():
    tables = tables_for("AGATCGGAAGAGCACACGTCTGAACTCCAGTCA")
    rng = np.random.default_rng(2)
    enc = rng.integers(0, 256, (300, 25), dtype=np.uint8)
    lens = rng.integers(1, 101, 300)
    ops, nbytes = work(enc, lens, tables, True)
    # padded rows of length 0 and padded columns of any content
    padded = np.zeros((4096, 40), np.uint8)
    padded[:300, :25] = enc
    padded[:300, 25:] = 0xFF
    plens = np.zeros(4096, np.int64)
    plens[:300] = lens
    assert work(padded, plens, tables, True) == (ops, nbytes)


def test_a_launch_of_padding_only():
    tables = tables_for("ACGTACGTAC")
    assert work(np.zeros((4096, 25), np.uint8), np.zeros(4096, np.int64),
                tables, True)[0] == 0
