import numpy as np

from raconx.ops.poa_host import StarGraph, consensus_window
from raconx.ops.nw_host import nw_align


def _arr(s: bytes) -> np.ndarray:
    return np.frombuffer(s, dtype=np.uint8)


def _layers(seqs, backbone_len):
    return [(_arr(s), None, 0, backbone_len - 1) for s in seqs]


def test_passthrough_below_three_sequences():
    bb = _arr(b"ACGTACGT")
    cons, ok = consensus_window(bb, None, _layers([b"ACGTACGT"], 8), True,
                                True, 3, -5, -4)
    assert cons == b"ACGTACGT"
    assert not ok


def test_substitution_corrected_by_majority():
    bb = _arr(b"ACGTACGTAA")  # backbone has error at pos 4 (should be G)
    reads = [b"ACGTGCGTAA"] * 5
    cons, ok = consensus_window(bb, None, _layers(reads, 10), False, False,
                                3, -5, -4)
    assert ok
    assert cons == b"ACGTGCGTAA"


def test_insertion_recovered():
    # all reads contain an extra TT the backbone lacks
    bb = _arr(b"AAAACCCCGGGG")
    reads = [b"AAAACCTTCCGGGG"] * 6
    cons, _ = consensus_window(bb, None, _layers(reads, 12), False, False,
                               3, -5, -4)
    assert cons == b"AAAACCTTCCGGGG"


def test_deletion_recovered():
    bb = _arr(b"AAAACCTTCCGGGG")
    reads = [b"AAAACCCCGGGG"] * 6
    cons, _ = consensus_window(bb, None, _layers(reads, 14), False, False,
                               3, -5, -4)
    assert cons == b"AAAACCCCGGGG"


def test_quality_weighting_beats_count():
    # two low-quality reads say C at pos 0, one high-quality read says A;
    # backbone (weight 0 dummy) says A
    bb = _arr(b"ATTTT")
    layers = [
        (_arr(b"CTTTT"), _arr(b"$$$$$"), 0, 4),  # phred 3
        (_arr(b"CTTTT"), _arr(b"$$$$$"), 0, 4),
        (_arr(b"ATTTT"), _arr(b"IIIII"), 0, 4),  # phred 40
    ]
    cons, _ = consensus_window(bb, None, layers, False, False, 3, -5, -4)
    assert cons[0:1] == b"A"


def test_trimming_low_coverage_ends():
    # 4 reads cover only the middle; TGS trimming should cut flanks
    bb = _arr(b"A" * 20)
    layers = [(_arr(b"A" * 10), None, 5, 14) for _ in range(4)]
    cons, ok = consensus_window(bb, None, layers, True, True, 3, -5, -4)
    assert ok
    assert 9 <= len(cons) <= 11  # middle region only


def test_star_graph_merges_identical_insertions():
    bb = _arr(b"AACC")
    g = StarGraph(bb, np.zeros(4, dtype=np.int32))
    _, ops = nw_align(_arr(b"AATCC"), bb, 3, -5, -4)
    w = np.ones(5, dtype=np.int32)
    g.add_path(ops, 0, _arr(b"AATCC"), w)
    n_nodes = len(g.base)
    g.add_path(ops, 0, _arr(b"AATCC"), w)
    assert len(g.base) == n_nodes  # second identical path creates no nodes
