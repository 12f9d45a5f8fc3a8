"""Polisher orchestration: the reference's CLI contract
(createPolisher -> initialize -> polish, src/polisher.cpp:55-548) re-built
around columnar data and batched backends.

Stage map (reference -> here):
  initialize targets/reads ingest + dedup   -> SequenceStore + name/id maps
  overlap transmute + filtering             -> OverlapTable (vectorized)
  find_overlap_breaking_points (edlib)      -> AlignStage backend
       backends: gpu (batched Myers bit-vector sweep), native (C++),
       python (numpy oracle)
  window construction + layer assignment    -> WindowSet (SoA)
  polish (spoa POA per window)              -> ConsensusStage backend
       backends: gpu (batched banded NW + native star-POA), native, python
"""

from __future__ import annotations

import sys

import numpy as np

from .errors import RaconError
from .io import open_sequence_parser, open_overlap_parser
from .core.store import SequenceStore
from .core.overlaps import OverlapTable
from .core.breakpoints import breaking_points_from_cigar
from .core.windows import (WindowSet, stitch, WINDOW_TYPE_NGS,
                           WINDOW_TYPE_TGS)
from .models.polish_model import PolisherConfig, PolisherType
from .utils.logger import Logger

kChunkSize = 1 << 30  # streaming parse unit (reference: src/polisher.cpp:26)


def _chunk_bytes() -> int:
    """Per-call so RACONX_CHUNK_BYTES works whenever it is set (the
    fastx path reads it the same way)."""
    import os
    return int(os.environ.get("RACONX_CHUNK_BYTES", kChunkSize))


def create_polisher(sequences_path: str, overlaps_path: str, target_path: str,
                    config: PolisherConfig) -> "Polisher":
    """Validate configuration and open parsers
    (reference: src/polisher.cpp:55-160)."""
    if not isinstance(config.type, PolisherType):
        raise RaconError("[racon::createPolisher] error: invalid polisher type!")
    if config.window_length == 0:
        raise RaconError("[racon::createPolisher] error: invalid window length!")
    sparser = open_sequence_parser(sequences_path)
    oparser = open_overlap_parser(overlaps_path)
    tparser = open_sequence_parser(target_path)
    return Polisher(sparser, oparser, tparser, config)


class Polisher:
    def __init__(self, sparser, oparser, tparser, config: PolisherConfig):
        self.sparser = sparser
        self.oparser = oparser
        self.tparser = tparser
        self.config = config
        self.logger = Logger()
        self.sequences: SequenceStore | None = None
        self.windows: WindowSet | None = None
        self.targets_size = 0
        self.targets_coverages: np.ndarray | None = None
        self._initialized = False

    # ------------------------------------------------------------------ #

    def initialize(self) -> None:
        if self._initialized:
            sys.stderr.write("[racon::Polisher::initialize] warning: "
                             "object already initialized!\n")
            return
        self._initialized = True
        cfg = self.config
        log = self.logger
        log.log()

        targets = self.tparser.parse_store()
        targets_size = len(targets)
        if targets_size == 0:
            raise RaconError("[racon::Polisher::initialize] error: "
                             "empty target sequences set!")
        self.targets_size = targets_size

        name_to_id: dict[bytes, int] = {}
        id_to_id: dict[int, int] = {}
        for i in range(targets_size):
            name_to_id[targets.names[i] + b"t"] = i
            id_to_id[i << 1 | 1] = i

        log.log("[racon::Polisher::initialize] loaded target sequences")
        log.log()

        # reads; duplicates of targets (same name + equal data/quality length)
        # share the target's record (reference: src/polisher.cpp:229-264)
        reads = self.sparser.parse_store()
        sequences_size = len(reads)
        if sequences_size == 0:
            raise RaconError("[racon::Polisher::initialize] error: "
                             "empty sequences set!")
        total_sequences_length = int(reads.data_off[-1])
        rlen = reads.lengths()
        rqlen = np.diff(reads.qual_off)
        tqlen = np.diff(targets.qual_off)
        keep = np.ones(sequences_size, dtype=bool)
        dup_tid = np.full(sequences_size, -1, dtype=np.int64)
        for i in range(sequences_size):
            tid = name_to_id.get(reads.names[i] + b"t")
            if tid is not None:
                if (rlen[i] != targets.length(tid) or
                        rqlen[i] != tqlen[tid]):
                    raise RaconError(
                        "[racon::Polisher::initialize] error: duplicate "
                        "sequence %s with unequal data"
                        % reads.names[i].decode())
                keep[i] = False
                dup_tid[i] = tid
        kept_before = np.cumsum(keep) - keep
        for i in range(sequences_size):
            internal = (int(dup_tid[i]) if dup_tid[i] >= 0
                        else targets_size + int(kept_before[i]))
            name_to_id[reads.names[i] + b"q"] = internal
            id_to_id[i << 1 | 0] = internal

        from .core.store import merge_stores
        sequences = merge_stores(targets, reads, keep)
        self.sequences = sequences

        window_type = (WINDOW_TYPE_NGS if total_sequences_length /
                       sequences_size <= 1000 else WINDOW_TYPE_TGS)

        log.log("[racon::Polisher::initialize] loaded sequences")
        log.log()

        # chunked streaming parse + in-stream filtering (reference:
        # kChunkSize = 1 GiB, src/polisher.cpp:26,310-355): host memory is
        # bounded by one chunk of text plus surviving records; the run that
        # straddles a chunk boundary is carried to the next chunk before
        # filtering, exactly like the reference's c/l bookkeeping
        keep_longest = cfg.type == PolisherType.kC
        kept: list[OverlapTable] = []
        carry: OverlapTable | None = None

        def _filter_into_kept(table: OverlapTable) -> None:
            keep = table.filter_invalid(cfg.error_threshold,
                                        keep_longest_per_query=keep_longest)
            table.compact(keep)
            if len(table):
                kept.append(table)

        for chunk in self.oparser.parse_chunks(_chunk_bytes()):
            chunk.transmute(sequences, name_to_id, id_to_id)
            work = OverlapTable.concat([carry, chunk]) if carry else chunk
            head, carry = work.split_at(work.trailing_run_start())
            _filter_into_kept(head)
        if carry is not None:
            _filter_into_kept(carry)
        overlaps = OverlapTable.concat(kept) if kept else OverlapTable()
        del kept
        if len(overlaps) == 0:
            raise RaconError("[racon::Polisher::initialize] error: "
                             "empty overlap set!")

        log.log("[racon::Polisher::initialize] loaded overlaps")
        log.log()

        # lazy reverse complements for reverse-strand queries
        # (reference: src/polisher.cpp:337-347,369-378)
        rev_ids = np.unique(overlaps.q_id[overlaps.strand])
        sequences.prepare_reverse(rev_ids)

        breaking_points = self._find_breaking_points(overlaps)

        log.log()

        windows = WindowSet(sequences, targets_size, cfg.window_length,
                            window_type)
        self.targets_coverages = np.zeros(targets_size, dtype=np.int64)
        for i in range(len(overlaps)):
            self.targets_coverages[overlaps.t_id[i]] += 1
            windows.assign_overlap(breaking_points[i], int(overlaps.q_id[i]),
                                   int(overlaps.t_id[i]),
                                   bool(overlaps.strand[i]),
                                   cfg.quality_threshold)
        windows.freeze()
        self.windows = windows

        log.log("[racon::Polisher::initialize] transformed data into windows")

    # ------------------------------------------------------------------ #

    def _find_breaking_points(self, overlaps: OverlapTable) -> list[np.ndarray]:
        """Dispatch the alignment stage to the configured backend; SAM
        records that carry a CIGAR are walked directly. Under multi-process
        runs (parallel/dist.py) each process aligns a contiguous shard of
        the overlaps and the breaking points are all-gathered."""
        from .backends import get_align_stage
        from .parallel import dist
        stage = get_align_stage(self.config)

        w = self.config.window_length

        out: list[np.ndarray | None] = [None] * len(overlaps)
        need_align: list[int] = []
        for i in range(len(overlaps)):
            if overlaps.cigars[i]:
                out[i] = breaking_points_from_cigar(
                    overlaps.cigars[i], bool(overlaps.strand[i]),
                    int(overlaps.q_begin[i]), int(overlaps.q_end[i]),
                    int(overlaps.q_length[i]), int(overlaps.t_begin[i]),
                    int(overlaps.t_end[i]), w)
            else:
                need_align.append(i)
        if need_align and dist.is_active():
            lo, hi = dist.shard_range(len(need_align))
            local = stage.breaking_points(
                overlaps, need_align[lo:hi], self.sequences, w, self.logger)
            aligned = dist.allgather_ragged(local, np.int64, trailing=(4,))
            assert len(aligned) == len(need_align)
        elif need_align:
            aligned = stage.breaking_points(
                overlaps, need_align, self.sequences, w, self.logger)
        else:
            aligned = []
        for i, bp in zip(need_align, aligned):
            out[i] = bp
        self.logger.log("[racon::Polisher::initialize] aligned overlaps")
        return out

    # ------------------------------------------------------------------ #

    def polish(self, drop_unpolished_sequences: bool) -> list[tuple[bytes, bytes]]:
        from .backends import get_consensus_stage
        from .parallel import dist
        cfg = self.config
        self.logger.log()
        stage = get_consensus_stage(cfg)
        if dist.is_active():
            # multi-process: each process polishes a contiguous window
            # shard; consensus bytes ride point-to-point to process 0 only
            # (the sole stitcher — gather_ragged_to0 costs ~1/N the bytes
            # of an every-process allgather) and process 0 stitches +
            # prints (SURVEY.md §5.8)
            lo, hi = dist.shard_range(self.windows.num_windows)
            local_c, local_p = stage.consensus_windows(
                self.windows.shard(lo, hi), cfg, self.logger)
            parts = dist.gather_ragged_to0(
                [np.frombuffer(c, np.uint8) for c in local_c], np.uint8)
            flags = dist.gather_blob_to0(np.asarray(local_p, np.uint8))
            if dist.process_index() != 0:
                self.logger.log("[racon::Polisher::polish] generated "
                                "consensus")
                return []
            consensus = [p.tobytes() for p in parts]
            polished = [bool(f) for f in np.concatenate(flags)]
            assert len(consensus) == self.windows.num_windows
        else:
            consensus, polished = stage.consensus_windows(
                self.windows, cfg, self.logger)
        dst = stitch(consensus, polished, self.windows, self.sequences,
                     self.targets_coverages,
                     cfg.type == PolisherType.kF, drop_unpolished_sequences)
        self.logger.log("[racon::Polisher::polish] generated consensus")
        return dst

    def total(self) -> None:
        self.logger.total("[racon::Polisher::] total =")
