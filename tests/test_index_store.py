"""Index store (flat-array dir, mmap load) + adaptive first level."""

import numpy as np
import pytest

from pansvr_tpu.index.builder import build_index, resolve_first_level
from pansvr_tpu.index.store import is_index_dir, load_any, load_index, save_index
from pansvr_tpu.utils.simulate import make_dataset
from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
from pansvr_tpu.utils.simulate import DictGenome


def _contigs(seed=3, n_sv=12):
    ds = make_dataset(seed=seed, n_sv=n_sv, n_pairs=0,
                      types=("DEL", "INS", "DUP"))
    recs = [sv.to_vcf_record(i) for i, sv in enumerate(ds.svs)]
    anchors = build_anchor_contigs(recs, DictGenome(ds.genome),
                                   AnchorConfig())
    return [(c.name, c.seq) for c in anchors]


def test_store_roundtrip(tmp_path):
    idx = build_index(_contigs(), first_level_bases=9)
    d = str(tmp_path / "rdbg")
    save_index(idx, d)
    assert is_index_dir(d)
    for mmap in (True, False):
        back = load_index(d, mmap=mmap)
        assert (back.k, back.search_k, back.first_level_bases) == (
            idx.k, idx.search_k, idx.first_level_bases)
        assert back.chr_names == idx.chr_names
        for f in ("ref_codes", "ref_words", "chr_starts", "uni_codes",
                  "uni_words", "uni_seqf", "uni_pos", "uni_posp",
                  "hash_g", "kmer_g", "off_g"):
            a, b = getattr(idx, f), getattr(back, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_load_any_pkl(tmp_path):
    import pickle

    idx = build_index(_contigs(), first_level_bases=9)
    d = tmp_path / "idxdir"
    d.mkdir()
    with open(d / "rdbg.pkl", "wb") as fh:
        pickle.dump(idx, fh)
    back = load_any(str(d))
    np.testing.assert_array_equal(back.kmer_g, idx.kmer_g)


def test_resolve_first_level():
    assert resolve_first_level(14, 10) == 14      # explicit wins
    assert resolve_first_level("auto", 0) == 8
    assert resolve_first_level("auto", 1 << 16) == 8
    assert resolve_first_level("auto", (1 << 16) + 1) == 9
    assert resolve_first_level("auto", 2_329_887) == 11
    assert resolve_first_level("auto", 1 << 40) == 14  # capped


def test_auto_fl_same_results():
    """Auto-fl index answers identical queries to an fl=14-style index
    (different bucketing, same entry set)."""
    contigs = _contigs(seed=5)
    a = build_index(contigs, first_level_bases="auto")
    b = build_index(contigs, first_level_bases=12)
    assert a.first_level_bases < 12 or a.n_kmers > (1 << 22)
    # entry tables sort by full k-mer value in both: off_g identical
    np.testing.assert_array_equal(a.off_g, b.off_g)
    np.testing.assert_array_equal(a.uni_pos, b.uni_pos)
    assert a.hash_g[-1] == b.hash_g[-1] == a.n_kmers


def test_engine_on_mmapped_index(tmp_path):
    """The engine runs (and matches itself) on a read-only mmap-loaded
    index — the fc_aln load path at scale."""
    from pansvr_tpu.align.engine import AlignEngine, EngineConfig
    from pansvr_tpu.align.host_align import OriResult

    contigs = _contigs(seed=7)
    idx = build_index(contigs, first_level_bases="auto")
    d = str(tmp_path / "rdbg")
    save_index(idx, d)
    mm = load_any(d)
    assert isinstance(mm.hash_g, np.memmap)

    ds = make_dataset(seed=7, n_sv=12, n_pairs=24,
                      types=("DEL", "INS", "DUP"))
    seqs = [s for r in ds.reads[:16] for s in (r.seq1, r.seq2)]
    oris = [OriResult(unmapped=True) for _ in seqs]
    cfg = EngineConfig()
    sa = AlignEngine(idx, config=cfg).align_batch(seqs, oris)
    sb = AlignEngine(mm, config=cfg).align_batch(seqs, oris)
    for x, y in zip(sa, sb):
        assert len(x.results) == len(y.results)
        for rx, ry in zip(x.results, y.results):
            assert (rx.align_score, rx.ref_bg, rx.cigar) == (
                ry.align_score, ry.ref_bg, ry.cigar)
