"""Iterative greedy de Bruijn assembler (Manta-style word ladder).

Clean-room implementation of the behavioral contract documented in
SURVEY.md §8.1 (after src/cpp_lib/Assembler/mantaAssembler.{hpp,cpp}, an
Illumina Manta derivation): word lengths 26..126 step 10 with pseudo-read
re-injection, greedy bidirectional contig walks with per-branch allele
read bookkeeping, Tarjan small-circle repeat detection, and greedy
set-cover contig selection. Every support add/remove is journaled as an
action (kmer_index, read_id, is_add) — downstream position voting
(fc_sv) replays this journal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MAX_ALLELE_AS_SNP = 1


@dataclass
class AssemblerOptions:
    alphabet: str = "ACGT"
    min_word_length: int = 26
    max_word_length: int = 126
    max_word_length_without_enough_read: int = 126
    word_step: int = 10
    min_contig_length: int = 45
    min_coverage: int = 2
    min_conservative_coverage: int = 2
    min_unused_reads: int = 3
    min_support_reads: int = 3
    max_assembly_count: int = 10
    reject_read_reused: bool = False


@dataclass
class AssembledContig:
    seq: str = ""
    support_reads: set = field(default_factory=set)
    reject_reads: set = field(default_factory=set)
    seed_read_count: int = 0
    word_length: int = 0
    # journal of support changes: (kmer_index_in_contig, read_id, is_add)
    actions: list = field(default_factory=list)
    ass_begin_offset_in_contig: int = 0  # final leftward extension count (<=0)
    conservative_range_bgn: int = 0
    conservative_range_end: int = 0
    ending_reason: list = field(default_factory=lambda: [-1, -1])
    new_support_read: int = 0


def _add_base(s: str, c: str, at_end: bool) -> str:
    return s[1:] + c if at_end else c + s[:-1]


def _get_end(s: str, length: int, at_end: bool) -> str:
    return s[-length:] if at_end else s[:length]


class AssemblyManager:
    def __init__(self, options: AssemblerOptions | None = None):
        self.o = options or AssemblerOptions()
        self.reads: list[str] = []
        self.read_is_pseudo: list[bool] = []
        self.contigs: list[AssembledContig] = []
        self._tmp_contigs: list[AssembledContig] = []

    def clear(self):
        self.reads = []
        self.read_is_pseudo = []
        self.contigs = []

    def add_read(self, seq: str):
        self.reads.append(seq)

    def set_repeat_mode(self):
        self.o.reject_read_reused = True
        self.o.max_assembly_count = 5

    def set_normal_mode(self):
        self.o.reject_read_reused = False
        self.o.max_assembly_count = 10

    # ------------------------------------------------------------------
    def _kmer_maps(self, wl: int):
        word_count: dict[str, int] = {}
        word_reads: dict[str, set] = {}
        for ridx, seq in enumerate(self.reads):
            if len(seq) < wl:
                continue
            words = set()
            for j in range(len(seq) - wl + 1):
                w = seq[j : j + wl]
                if "N" not in w:
                    words.add(w)
            add = self.o.min_coverage if self.read_is_pseudo[ridx] else 1
            for w in words:
                word_count[w] = word_count.get(w, 0) + add
                word_reads.setdefault(w, set()).add(ridx)
        return word_count, word_reads

    def _repeat_words(self, word_count) -> set:
        """Tarjan SCC over the k-mer successor graph (iterative): circles
        of <= 50 words and homopolymer self-loops are repeats."""
        alphabet = self.o.alphabet
        index_of: dict[str, list] = {w: [0, 0] for w in word_count}
        repeats: set[str] = set()
        stack: list[str] = []
        on_stack: set[str] = set()
        counter = 1

        for root in sorted(index_of):
            if index_of[root][0] != 0:
                continue
            work = [(root, 0)]
            index_of[root] = [counter, counter]
            counter += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                w, si = work[-1]
                if si < len(alphabet):
                    work[-1] = (w, si + 1)
                    nxt = w[1:] + alphabet[si]
                    if nxt == w:
                        repeats.add(w)
                        continue
                    if nxt not in index_of:
                        continue
                    if index_of[nxt][0] == 0:
                        index_of[nxt] = [counter, counter]
                        counter += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, 0))
                    elif nxt in on_stack:
                        index_of[w][1] = min(index_of[w][1], index_of[nxt][0])
                    continue
                work.pop()
                if work:
                    p = work[-1][0]
                    index_of[p][1] = min(index_of[p][1], index_of[w][1])
                if index_of[w][1] == index_of[w][0]:
                    if stack[-1] == w:
                        stack.pop()
                        on_stack.discard(w)
                    else:
                        small = (index_of[stack[-1]][0] - index_of[w][0]) <= 50
                        while True:
                            rw = stack.pop()
                            on_stack.discard(rw)
                            if small:
                                repeats.add(rw)
                            if rw == w:
                                break
        return repeats

    # ------------------------------------------------------------------
    def _walk(self, seed, wl, word_count, word_reads, repeat_words,
              unused_words):
        o = self.o
        contig = AssembledContig(seq=seed, word_length=wl)
        contig.support_reads = set(word_reads[seed])
        contig.seed_read_count = len(contig.support_reads)
        for rd in sorted(contig.support_reads):
            contig.actions.append((0, rd, True))
        unused_words.discard(seed)

        if seed in repeat_words:
            contig.conservative_range_bgn = 0
            contig.conservative_range_end = wl
            contig.ending_reason = [1, 1]
            return True, contig

        words_in_contig = {seed}
        # rejecting reads from the seed's unselected sibling branches
        trunk0 = seed[: wl - 1]
        for sym in o.alphabet:
            if sym == seed[wl - 1]:
                continue
            sib = trunk0 + sym
            if sib in word_reads:
                contig.reject_reads |= word_reads[sib]

        is_repeat_found = False
        kmer_index = 0
        for mode in (0, 1):
            at_end = mode == 0
            step = 1 if at_end else -1
            kmer_index = 0
            conservative_off = 0
            while True:
                previous_word = _get_end(contig.seq, wl, at_end)
                trunk = _get_end(contig.seq, wl - 1, at_end)
                max_base_count = 0
                max_contig_word_reads: set = set()
                max_word_reads: set = set()
                max_word = ""
                max_base = o.alphabet[0]
                support_to_remove: set = set()
                reject_to_add: set = set()

                for sym in o.alphabet:
                    new_key = (trunk + sym) if at_end else (sym + trunk)
                    cnt = word_count.get(new_key)
                    if cnt is None:
                        continue
                    curr_reads = word_reads.get(new_key)
                    if curr_reads is None:
                        continue
                    contig_word_reads = contig.support_reads & curr_reads
                    shared = max_contig_word_reads & curr_reads
                    if not contig_word_reads:
                        continue
                    if len(contig_word_reads) > len(max_contig_word_reads):
                        if max_contig_word_reads:
                            to_remove = max_contig_word_reads - shared
                            if len(to_remove) > MAX_ALLELE_AS_SNP:
                                support_to_remove |= to_remove
                        if max_word_reads:
                            to_add = max_word_reads - shared
                            if len(to_add) > MAX_ALLELE_AS_SNP:
                                reject_to_add |= to_add
                        max_word_reads = set(curr_reads)
                        max_contig_word_reads = contig_word_reads
                        max_base_count = cnt
                        max_base = sym
                        max_word = new_key
                    else:
                        to_remove = contig_word_reads - shared
                        if len(to_remove) > MAX_ALLELE_AS_SNP:
                            support_to_remove |= to_remove
                        to_add = curr_reads - shared
                        if len(to_add) > MAX_ALLELE_AS_SNP:
                            reject_to_add |= to_add

                if max_base_count < o.min_coverage:
                    contig.ending_reason[1 - mode] = 0
                    break
                if max_word in words_in_contig:
                    is_repeat_found = True
                    contig.ending_reason[1 - mode] = 1
                    break

                contig.seq = (contig.seq + max_base) if at_end else (max_base + contig.seq)
                kmer_index += step
                if conservative_off != 0 or max_base_count < o.min_conservative_coverage:
                    conservative_off += 1

                # branch-point backward pass (the reference clears its
                # previousWordReads buffer every iteration, so this runs
                # whenever an extension word was found)
                tmp_sym = previous_word[0] if at_end else previous_word[wl - 1]
                for sym in o.alphabet:
                    if sym == tmp_sym:
                        continue
                    back_key = (sym + trunk) if at_end else (trunk + sym)
                    if back_key == max_word:
                        continue
                    back_reads = word_reads.get(back_key)
                    if back_reads is None:
                        continue
                    shared_al = max_contig_word_reads & back_reads
                    to_update = back_reads - shared_al
                    if len(to_update) > MAX_ALLELE_AS_SNP:
                        reject_to_add |= to_update
                        support_to_remove |= to_update

                contig.reject_reads |= reject_to_add
                for rd in sorted(max_word_reads):
                    if o.reject_read_reused:
                        if rd not in contig.support_reads:
                            contig.support_reads.add(rd)
                            contig.actions.append((kmer_index, rd, True))
                    else:
                        if rd not in contig.reject_reads and rd not in contig.support_reads:
                            contig.support_reads.add(rd)
                            contig.actions.append((kmer_index, rd, True))
                for rd in sorted(support_to_remove):
                    if rd in contig.support_reads:
                        contig.support_reads.discard(rd)
                        contig.actions.append((kmer_index, rd, False))

                unused_words.discard(max_word)
                words_in_contig.add(max_word)

            if mode == 0:
                contig.conservative_range_end = conservative_off
            else:
                contig.conservative_range_bgn = conservative_off

        contig.ass_begin_offset_in_contig = min(kmer_index, 0)
        contig.conservative_range_end = len(contig.seq) - contig.conservative_range_end
        return is_repeat_found, contig

    # ------------------------------------------------------------------
    def _build_contigs_native(self, wl: int):
        """One word-length pass in C++ (native_glue.asm_build_contigs) —
        bit-identical contigs/journals to the Python loops (tested).
        Returns None when the library isn't built."""
        from ..align import native_glue

        lib = native_glue.get_lib()
        if lib is None:
            return None
        res = native_glue.asm_build_contigs(
            lib, self.reads, self.read_is_pseudo, wl,
            self.o.min_coverage, self.o.min_conservative_coverage,
            self.o.max_assembly_count, self.o.reject_read_reused,
        )
        success, gmax, raw = res
        self._tmp_contigs = []
        for r in raw:
            m = r["meta"]
            self._tmp_contigs.append(AssembledContig(
                seq=r["seq"],
                support_reads=set(int(x) for x in r["support"]),
                reject_reads=set(int(x) for x in r["reject"]),
                actions=r["actions"],
                seed_read_count=int(m[0]), word_length=int(m[1]),
                ass_begin_offset_in_contig=int(m[2]),
                conservative_range_bgn=int(m[3]),
                conservative_range_end=int(m[4]),
                ending_reason=[int(m[5]), int(m[6])],
            ))
        return success, gmax

    def _build_contigs(self, wl: int):
        native = self._build_contigs_native(wl)
        if native is not None:
            return native
        word_count, word_reads = self._kmer_maps(wl)
        repeat_words = self._repeat_words(word_count)
        unused = {w for w, c in word_count.items() if c >= self.o.min_coverage}

        self._tmp_contigs = []
        success = True
        normal_contig = 0
        global_max_count = 0
        while unused and normal_contig < 2 * self.o.max_assembly_count:
            max_word = ""
            max_count = 0
            for w in sorted(unused):
                if word_count[w] > max_count:
                    max_word = w
                    max_count = word_count[w]
            global_max_count = max(global_max_count, max_count)
            repeat, contig = self._walk(
                max_word, wl, word_count, word_reads, repeat_words, unused
            )
            if repeat:
                success = False
            if len(contig.seq) > wl:
                normal_contig += 1
            self._tmp_contigs.append(contig)
        return success, global_max_count

    def _select_contigs(self, normal_read_count: int):
        o = self.o
        self.contigs = []
        used_reads: set = set()
        used_pseudo: set = set()
        tmp = self._tmp_contigs
        while tmp and len(self.contigs) < o.max_assembly_count:
            used_normal = len(used_reads) - len(used_pseudo)
            if normal_read_count - used_normal < o.min_unused_reads:
                return
            to_remove = set()
            selected = None
            selected_idx = -1
            max_support = 0
            max_length = 0
            for ci, contig in enumerate(tmp):
                new_support = contig.support_reads - used_reads
                new_normal = sum(
                    1 for rd in new_support if not self._is_pseudo(rd)
                )
                if self.contigs and new_normal < o.min_support_reads:
                    to_remove.add(ci)
                    continue
                better = len(new_support) > max_support or (
                    len(new_support) == max_support and len(contig.seq) > max_length
                )
                if better:
                    selected = contig
                    selected.new_support_read = new_normal
                    selected_idx = ci
                    max_support = len(new_support)
                    max_length = len(contig.seq)
            if max_support == 0:
                break
            self.contigs.append(selected)
            to_remove.add(selected_idx)
            self._tmp_contigs = [
                c for ci, c in enumerate(tmp) if ci not in to_remove
            ]
            tmp = self._tmp_contigs
            for rd in selected.support_reads:
                used_reads.add(rd)
                if self._is_pseudo(rd):
                    used_pseudo.add(rd)

    def _is_pseudo(self, rd: int) -> bool:
        """Support indices can outlive the pseudo-read truncation of the
        final failed word-length iteration (the reference indexes
        readInfo out of range in exactly this state — selectContigs,
        mantaAssembler.cpp:583-588 after the erase at :654-661, which is
        UB in C++). Every such stale index referred to a pseudo read, so
        count it as one."""
        return rd >= len(self.read_is_pseudo) or self.read_is_pseudo[rd]

    # ------------------------------------------------------------------
    def assemble(self) -> list[AssembledContig]:
        o = self.o
        normal_read_count = len(self.reads)
        self.read_is_pseudo = [False] * normal_read_count
        global_max_count = 0
        wl = o.min_word_length
        while wl <= o.max_word_length and not (
            global_max_count < 100 and wl > o.max_word_length_without_enough_read
        ):
            success, global_max_count = self._build_contigs(wl)
            if success:
                break
            # drop pseudo reads from the previous iteration
            for ridx in range(len(self.reads)):
                if self.read_is_pseudo[ridx]:
                    self.reads = self.reads[:ridx]
                    self.read_is_pseudo = self.read_is_pseudo[:ridx]
                    break
            # re-inject long contigs as pseudo reads
            for contig in self._tmp_contigs:
                if len(contig.seq) > wl + o.word_step:
                    self.reads.append(contig.seq)
                    self.read_is_pseudo.append(True)
            wl += o.word_step
        self._select_contigs(normal_read_count)
        return self.contigs
