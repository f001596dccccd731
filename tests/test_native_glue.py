"""Native engine glue (native/engine_glue.cpp) vs the pure-Python
collect/replay path: SingleEndState results must be bit-identical.

The library is built from native/engine_glue.cpp at first use."""

import numpy as np
import pytest

from pansvr_tpu.align import native_glue
from pansvr_tpu.align.engine import AlignEngine, EngineConfig
from pansvr_tpu.align.host_align import OriResult
from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
from pansvr_tpu.index.builder import build_index
from pansvr_tpu.utils.simulate import DictGenome, make_dataset

def _key(results):
    return [
        (r.direction, r.chain_score, r.align_score, r.read_bg, r.ref_bg,
         r.sv_id, r.mapq, r.rst_idx, tuple(r.cigar))
        for r in results
    ]


def test_native_glue_matches_python_path():
    ds = make_dataset(seed=321, n_sv=24, n_pairs=1200, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 600_000}, err_rate=0.004)
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=12)
    seqs = []
    for r in ds.reads:
        seqs.append(r.seq1)
        seqs.append(r.seq2)
    oris = [OriResult(unmapped=True)] * len(seqs)
    B = 1024
    eng_n = AlignEngine(idx, ori_chrom_names=list(ds.genome),
                        config=EngineConfig(native_glue=True))
    eng_p = AlignEngine(idx, ori_chrom_names=list(ds.genome),
                        config=EngineConfig(native_glue=False))
    assert eng_n._glue_lib is not None
    st_n = eng_n.align_batch(seqs[:B], oris[:B])
    st_p = eng_p.align_batch(seqs[:B], oris[:B])
    n_with = 0
    for a, b in zip(st_n, st_p):
        assert _key(a.results) == _key(b.results)
        n_with += bool(b.results)
    assert n_with > B // 4  # the batch actually aligned things


def test_native_extd2_matches_oracle():
    """The C++ extd2 kernel must be bit-identical to the ksw2_ref oracle
    (scores, aux maxima, zdrop, CIGAR) across both scoring profiles."""
    import numpy as np

    from pansvr_tpu.align import native_glue
    from pansvr_tpu.ops import ksw2_ref

    lib = native_glue.get_lib()
    assert lib is not None
    rng = np.random.default_rng(11)
    profiles = [
        dict(match=2, mismatch=-12, q=16, e=1, q2=32, e2=0, w=200, zdrop=400),
        dict(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1, w=132, zdrop=132),
    ]
    for it in range(120):
        prof = profiles[it % 2]
        ql = int(rng.integers(1, 260))
        qc = rng.integers(0, 4, ql).astype(np.uint8)
        if rng.random() < 0.7:
            tl = max(1, min(300, ql + int(rng.integers(-20, 21))))
            tc = (qc[:tl].copy() if tl <= ql else np.concatenate(
                [qc, rng.integers(0, 4, tl - ql).astype(np.uint8)]))
            mut = rng.random(tl) < 0.05
            tc[mut] = (tc[mut] + 1) % 4
        else:
            tl = int(rng.integers(1, 300))
            tc = rng.integers(0, 4, tl).astype(np.uint8)
        a = ksw2_ref.extd2(qc, tc, **prof)
        b = native_glue.extd2_native(lib, qc, tc, **prof)
        for f in ("score", "mqe", "mqe_t", "mte", "mte_q", "max", "max_q",
                  "max_t", "zdropped", "cigar"):
            assert getattr(a, f) == getattr(b, f), \
                f"iter {it} ql={ql} tl={tl} field {f}"


def test_native_parse_comments_matches_python():
    """glue_parse_comments vs pipeline.parse_signal_comment on real-shaped
    and adversarial comment strings (grammar: read_realignment.hpp:392-429)."""
    from pansvr_tpu.pipeline import parse_signal_comment

    assert native_glue.parse_comments(["0_1_2_3_4_x_x_x_x_FN"]) is not None
    rng = np.random.default_rng(5)
    comments = []
    for _ in range(200):
        f = [str(int(rng.integers(-5, 30))) for _ in range(5)]
        mid = [str(int(rng.integers(0, 1000))) for _ in range(4)]
        flags = ("F" if rng.random() < 0.5 else "R") + \
                ("Y" if rng.random() < 0.5 else "N")
        tail = ["STAT", "150", "100", "300", "500"] \
            if rng.random() < 0.3 else []
        comments.append("_".join(f + mid + [flags] + tail))
    mat = native_glue.parse_comments(comments)
    assert mat is not None and mat.shape == (len(comments), 8)
    for i, c in enumerate(comments):
        o, _ = parse_signal_comment(c)
        row = mat[i]
        assert (int(row[0]), int(row[1]), int(row[2]), int(row[3]),
                int(row[4]), int(row[5]), bool(row[6])) == (
            o.chr_id, o.ref_bg, o.read_bg, o.align_score, o.mapq,
            o.direction, o.unmapped), f"comment {i}: {c}"
