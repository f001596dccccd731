"""Native (C++) word-ladder assembler pass vs the Python loops: contigs,
support/reject sets, action journals and metadata must be identical."""

import numpy as np
import pytest

from pansvr_tpu.align import native_glue
from pansvr_tpu.assembly.assembler import AssemblerOptions, AssemblyManager


def _random_reads(rng, n_reads=40, sv=True):
    bases = "ACGT"
    ref = "".join(rng.choice(list(bases)) for _ in range(400))
    alt = ref[:180] + ref[260:] if sv else ref  # 80 bp deletion allele
    reads = []
    for _ in range(n_reads):
        src = alt if rng.random() < 0.7 else ref
        p = rng.integers(0, len(src) - 150)
        r = src[p : p + 150]
        if rng.random() < 0.3:  # a few errors
            q = int(rng.integers(0, 150))
            r = r[:q] + bases[int(rng.integers(4))] + r[q + 1 :]
        reads.append(r)
    return reads


def _assemble(reads, native: bool, repeat_mode=False):
    am = AssemblyManager(AssemblerOptions())
    if repeat_mode:
        am.set_repeat_mode()
    if not native:
        am._build_contigs_native = lambda wl: None
    for r in reads:
        am.add_read(r)
    return am.assemble()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("repeat_mode", [False, True])
def test_native_assembler_matches_python(seed, repeat_mode):
    rng = np.random.default_rng(seed)
    reads = _random_reads(rng, n_reads=40, sv=seed % 2 == 0)
    # plant a tandem repeat read set on one seed to exercise the
    # repeat/Tarjan path
    if seed == 3:
        unit = reads[0][:30]
        reads += [unit * 5 + reads[1][:20] for _ in range(6)]
    cn = _assemble(reads, native=True, repeat_mode=repeat_mode)
    cp = _assemble(reads, native=False, repeat_mode=repeat_mode)
    assert len(cn) == len(cp)
    for a, b in zip(cn, cp):
        assert a.seq == b.seq
        assert a.support_reads == b.support_reads
        assert a.reject_reads == b.reject_reads
        assert a.actions == b.actions
        assert a.seed_read_count == b.seed_read_count
        assert a.word_length == b.word_length
        assert a.ass_begin_offset_in_contig == b.ass_begin_offset_in_contig
        assert a.conservative_range_bgn == b.conservative_range_bgn
        assert a.conservative_range_end == b.conservative_range_end
        assert a.ending_reason == b.ending_reason
