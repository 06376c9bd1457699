"""Genotyping engine: read-group coalescing, allele equivalence classes,
EM abundance quantification, allele selection and quality scoring.

Behavior contract: reference Genotyper.hpp (file:line cited per stage).
All floating-point bookkeeping mirrors the reference's types and
accumulation order — weights are float32, statistics are float64 — so
genotype calls are bit-identical.  The EM inner loop runs in the native
library (exact order) or on device (ops/em.py, tolerance-checked).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import (
    CROSS_ALLELE_RATE,
    DEFAULT_CROSS_GENE_RATE,
    DEFAULT_FILTER_COV,
    DEFAULT_FILTER_FRAC,
    EC_FINGERPRINT_MOD,
    EC_LIKELIHOOD_CUTOFF,
    MAX_EM_ITERATIONS,
    MAX_QUALITY,
    READ_GROUP_FINGERPRINT_MOD,
)
from .fragment import ReadAssignment


def alnorm(x: float, upper: bool) -> float:
    """AS66 standard normal CDF tail (Genotyper.hpp:252-370)."""
    a1, a2, a3 = 5.75885480458, 2.62433121679, 5.92885724438
    b1, b2 = -29.8213557807, 48.6959930692
    c1, c2, c3 = -0.000000038052, 0.000398064794, -0.151679116635
    c4, c5, c6 = 4.8385912808, 0.742380924027, 3.99019417011
    con = 1.28
    d1, d2, d3 = 1.00000615302, 1.98615381364, 5.29330324926
    d4, d5 = -15.1508972451, 30.789933034
    ltone, utzero = 7.0, 18.66
    p, q, r = 0.398942280444, 0.39990348504, 0.398942280385

    up = upper
    z = x
    if z < 0.0:
        up = not up
        z = -z
    if ltone < z and ((not up) or utzero < z):
        return 0.0 if up else 1.0
    y = 0.5 * z * z
    if z <= con:
        value = 0.5 - z * (p - q * y / (y + a1 + b1 / (y + a2 + b2 / (y + a3))))
    else:
        value = r * math.exp(-y) / (
            z + c1 + d1 / (z + c2 + d2 / (z + c3 + d3 / (
                z + c4 + d4 / (z + c5 + d5 / (z + c6))))))
    if not up:
        value = 1.0 - value
    return value


@dataclass
class GenotyperConfig:
    filter_frac: float = DEFAULT_FILTER_FRAC
    filter_cov: float = DEFAULT_FILTER_COV
    cross_gene_rate: float = DEFAULT_CROSS_GENE_RATE
    max_assign_cnt: int = 2000
    min_squarem_alpha: float = 0.0
    read_length: int = 0
    # "native" (exact f64), "jax" (device), or "auto": the device EM
    # when a GPU is present AND the problem is past the size gate
    # (small problems stay on the bit-exact native path, which also
    # keeps golden outputs byte-identical).
    em_backend: str = "auto"


class Genotyper:
    """Statistical core operating on coalesced read-group assignments."""

    def __init__(self, refset, config: Optional[GenotyperConfig] = None):
        self.refset = refset
        self.cfg = config or GenotyperConfig()
        self.last_em_route = "none"  # EM route quantify() took
        self.allele_cnt = len(refset)
        self.gene_cnt = refset.n_genes
        self.major_cnt = refset.n_major_alleles

        self.allele_gene = np.array([a.gene_idx for a in refset.alleles], dtype=np.int32)
        self.allele_major = np.array([a.major_allele_idx for a in refset.alleles], dtype=np.int32)
        self.allele_weight = np.array([a.weight for a in refset.alleles], dtype=np.int32)
        self.allele_eff_len = np.array([a.effective_len for a in refset.alleles], dtype=np.int32)
        self.allele_len = np.array([a.length for a in refset.alleles], dtype=np.int32)
        self.whitelist = np.ones(self.allele_cnt, dtype=bool)

        # read groups (post-coalesce).  The canonical storage is the flat
        # CSR below (built by coalesce_arrays, or from the object lists in
        # finalize for the object-based coalesce path); `read_groups`
        # holds objects only on that legacy path.
        self.read_groups: List[List[ReadAssignment]] = []
        self._fingerprint_to_idx: Dict[int, List[int]] = {}
        self._grp_off: Optional[np.ndarray] = None   # [G+1] int64
        self._flat_allele: Optional[np.ndarray] = None
        self._flat_start: Optional[np.ndarray] = None
        self._flat_end: Optional[np.ndarray] = None
        self._flat_weight: Optional[np.ndarray] = None  # float32
        self._flat_qual: Optional[np.ndarray] = None    # float32
        self._flat_adjust: Optional[np.ndarray] = None  # float32
        # reads-in-allele CSR: for each allele, (group, position) rows
        self._ria_off: Optional[np.ndarray] = None
        self._ria_grp: Optional[np.ndarray] = None
        self._ria_pos: Optional[np.ndarray] = None

        self.ec_to_alleles: List[List[int]] = []
        self.allele_ec = np.full(self.allele_cnt, -1, dtype=np.int64)
        self.allele_missing = np.zeros(self.allele_cnt, dtype=np.int32)

        self.abundance = np.zeros(self.allele_cnt, dtype=np.float64)
        self.ec_abundance_per_allele = np.zeros(self.allele_cnt, dtype=np.float64)
        self.major_abundance = np.zeros(self.major_cnt, dtype=np.float64)
        self.gene_abundance_arr = np.zeros(self.gene_cnt, dtype=np.float64)
        self.gene_max_major = np.zeros(self.gene_cnt, dtype=np.float64)

        self.genotype_quality = np.full(self.allele_cnt, -1, dtype=np.int64)
        self.allele_rank = np.full(self.allele_cnt, -1, dtype=np.int64)
        # per gene: list of (allele_idx, rank)
        self.selected_alleles: List[List[List[int]]] = [[] for _ in range(self.gene_cnt)]

    # ------------------------------------------------------- set whitelist
    def set_allele_whitelist(self, allele_names) -> None:
        """Restrict assignments to the major-allele series of the listed
        alleles (Genotyper.hpp:684-705)."""
        from ..io.refset import parse_allele_name

        self.whitelist[:] = False
        selected_majors = set()
        for name in allele_names:
            _, major = parse_allele_name(name, self.refset.digit_units, self.refset.delimiter)
            mi = self.refset.major_allele_name_to_idx.get(major)
            if mi is not None:
                selected_majors.add(mi)
        for i in range(self.allele_cnt):
            if int(self.allele_major[i]) in selected_majors:
                self.whitelist[i] = True

    # ----------------------------------------------------------- coalesce
    def coalesce(self, assignments: Sequence[List[ReadAssignment]]) -> int:
        """Merge identical assignment vectors into weighted read groups
        (Genotyper.hpp:841-908).  Returns the number of assigned fragments."""
        ret = 0
        for ra in assignments:
            if not ra:
                continue
            ret += 1
            ra = sorted(ra, key=lambda x: x.allele_idx)
            fp = 0
            for a in ra:
                fp = (fp * self.allele_cnt + a.allele_idx) % READ_GROUP_FINGERPRINT_MOD
            add_to = -1
            for idx in self._fingerprint_to_idx.get(fp, ()):
                if self._same_assignment(ra, self.read_groups[idx]):
                    add_to = idx
                    break
            if add_to == -1:
                self.read_groups.append(ra)
                self._fingerprint_to_idx.setdefault(fp, []).append(len(self.read_groups) - 1)
            else:
                tgt = self.read_groups[add_to]
                for j, a in enumerate(ra):
                    if a.qual == 1:
                        if a.start < tgt[j].start:
                            tgt[j].start = a.start
                        # quirk preserved from the reference
                        # (Genotyper.hpp:893-894): a smaller end writes the
                        # incoming *start* into the stored end
                        if a.end < tgt[j].end:
                            tgt[j].end = a.start
                    tgt[j].weight = np.float32(tgt[j].weight + a.weight)
                    tgt[j].adjust_weight = np.float32(tgt[j].adjust_weight + a.adjust_weight)
        return ret

    def coalesce_arrays(self, rec: np.ndarray, counts: np.ndarray) -> int:
        """Array-based coalescing over the native fragment stage's output
        (records [N,6]: allele/start/end/weight/adjust/qual).  Semantics
        identical to coalesce(): fragments with the same sorted
        (allele, qual) vector merge into one group, with the float32
        accumulation and the min-start / quirky-end updates applied in
        fragment order.  Writes the flat group CSR directly."""
        counts = np.asarray(counts, dtype=np.int64)
        off = np.zeros(len(counts) + 1, dtype=np.int64)
        off[1:] = np.cumsum(counts)
        n_rows = int(off[-1])

        alleles_all = rec[:, 0].astype(np.int64)
        frag_id = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        order = np.lexsort((alleles_all, frag_id))
        alleles_all = alleles_all[order]
        starts_all = rec[order, 1].astype(np.int64)
        ends_all = rec[order, 2].astype(np.int64)
        w_all = rec[order, 3].astype(np.float32)
        adj_all = rec[order, 4].astype(np.float32)
        q_all = rec[order, 5].astype(np.float32)

        groups: List[dict] = []
        key_to_idx: Dict[bytes, int] = {}
        ret = 0
        for i in range(len(counts)):
            s, e = int(off[i]), int(off[i + 1])
            if s == e:
                continue
            ret += 1
            alleles = alleles_all[s:e]
            quals = q_all[s:e]
            key = alleles.tobytes() + quals.tobytes()
            add_to = key_to_idx.get(key, -1)
            if add_to == -1:
                key_to_idx[key] = len(groups)
                groups.append({
                    "alleles": alleles,
                    "quals": quals,
                    "starts": starts_all[s:e].copy(),
                    "ends": ends_all[s:e].copy(),
                    "weights": w_all[s:e].copy(),
                    "adjusts": adj_all[s:e].copy(),
                })
            else:
                g = groups[add_to]
                starts = starts_all[s:e]
                ends = ends_all[s:e]
                q1 = quals == 1
                g["starts"] = np.where(q1 & (starts < g["starts"]),
                                       starts, g["starts"])
                # reference quirk: a smaller incoming end stores the
                # incoming *start* (Genotyper.hpp:893-894)
                g["ends"] = np.where(q1 & (ends < g["ends"]),
                                     starts, g["ends"])
                g["weights"] = g["weights"] + w_all[s:e]
                g["adjusts"] = g["adjusts"] + adj_all[s:e]

        gcnts = np.array([len(g["alleles"]) for g in groups], dtype=np.int64)
        goff = np.zeros(len(groups) + 1, dtype=np.int64)
        goff[1:] = np.cumsum(gcnts)
        if groups:
            self._flat_allele = np.concatenate([g["alleles"] for g in groups])
            self._flat_start = np.concatenate([g["starts"] for g in groups])
            self._flat_end = np.concatenate([g["ends"] for g in groups])
            self._flat_weight = np.concatenate([g["weights"] for g in groups])
            self._flat_qual = np.concatenate([g["quals"] for g in groups])
            self._flat_adjust = np.concatenate([g["adjusts"] for g in groups])
        else:
            self._flat_allele = np.zeros(0, np.int64)
            self._flat_start = np.zeros(0, np.int64)
            self._flat_end = np.zeros(0, np.int64)
            self._flat_weight = np.zeros(0, np.float32)
            self._flat_qual = np.zeros(0, np.float32)
            self._flat_adjust = np.zeros(0, np.float32)
        self._grp_off = goff
        del n_rows
        return ret

    def adopt_coalesced(self, coalesced: dict, assigned_cnt: int) -> int:
        """Adopt read groups coalesced inside the native engine
        (NativeEngine.fragment_batch_coalesced) — same semantics and
        iteration order as coalesce_arrays, with the per-record staging
        and grouping kept engine-side."""
        self._flat_allele = coalesced["allele"]
        self._flat_start = coalesced["start"]
        self._flat_end = coalesced["end"]
        self._flat_weight = coalesced["weight"]
        self._flat_qual = coalesced["qual"]
        self._flat_adjust = coalesced["adjust"]
        self._grp_off = coalesced["goff"]
        return assigned_cnt

    @staticmethod
    def _same_assignment(a: List[ReadAssignment], b: List[ReadAssignment]) -> bool:
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            if x.allele_idx != y.allele_idx or x.qual != y.qual:
                return False
        return True

    # ----------------------------------------------------------- finalize
    @property
    def read_group_count(self) -> int:
        if self._grp_off is not None:
            return len(self._grp_off) - 1
        return len(self.read_groups)

    def _build_group_arrays_from_objects(self) -> None:
        """Flatten the object read groups (legacy coalesce path) into the
        CSR arrays that the downstream stages operate on."""
        G = len(self.read_groups)
        gcnts = np.fromiter((len(ra) for ra in self.read_groups), np.int64, G)
        off = np.zeros(G + 1, dtype=np.int64)
        off[1:] = np.cumsum(gcnts)
        n = int(off[-1])
        allele = np.empty(n, np.int64)
        start = np.empty(n, np.int64)
        end = np.empty(n, np.int64)
        weight = np.empty(n, np.float32)
        qual = np.empty(n, np.float32)
        adjust = np.empty(n, np.float32)
        i = 0
        for ra in self.read_groups:
            for a in ra:
                allele[i] = a.allele_idx
                start[i] = a.start
                end[i] = a.end
                weight[i] = a.weight
                qual[i] = a.qual
                adjust[i] = a.adjust_weight
                i += 1
        self._grp_off = off
        self._flat_allele = allele
        self._flat_start = start
        self._flat_end = end
        self._flat_weight = weight
        self._flat_qual = qual
        self._flat_adjust = adjust

    def _ria_pairs(self, a: int):
        """(group, position) rows supporting allele a, in group order."""
        s, e = int(self._ria_off[a]), int(self._ria_off[a + 1])
        return zip(self._ria_grp[s:e].tolist(), self._ria_pos[s:e].tolist())

    def _ria_len(self, a: int) -> int:
        return int(self._ria_off[a + 1] - self._ria_off[a])

    def finalize(self, pos_weight: np.ndarray, packed) -> int:
        """Build reads-in-allele lists, equivalence classes, and per-allele
        missing coverage (Genotyper.hpp:912-939)."""
        if self._grp_off is None:
            self._build_group_arrays_from_objects()
        off = self._grp_off
        G = len(off) - 1
        ret = int(np.count_nonzero(np.diff(off)))
        # reads-in-allele CSR: rows sorted by allele, preserving
        # (group, position) order within each allele
        n = int(off[-1])
        rows = np.argsort(self._flat_allele, kind="stable")
        grp_of_row = np.repeat(np.arange(G, dtype=np.int64), np.diff(off))
        pos_of_row = np.arange(n, dtype=np.int64) - off[grp_of_row]
        self._ria_grp = grp_of_row[rows]
        self._ria_pos = pos_of_row[rows]
        self._ria_off = np.zeros(self.allele_cnt + 1, dtype=np.int64)
        np.cumsum(np.bincount(self._flat_allele, minlength=self.allele_cnt),
                  out=self._ria_off[1:])
        self._build_equivalence_classes()
        self._remove_low_mapq()
        self.allele_missing = compute_missing_coverage(self.refset, packed, pos_weight)
        return ret

    def _build_equivalence_classes(self) -> None:
        """Group alleles by identical supporting read sets; fingerprint with
        uint32 wraparound exactly like the reference (Genotyper.hpp:1072-1139)."""
        read_cnt = self.read_group_count
        fps = []
        for i in range(self.allele_cnt):
            s, e = int(self._ria_off[i]), int(self._ria_off[i + 1])
            if e > s:
                # uint32 wraparound fold, exactly as the reference computes it
                b = 0
                for a in self._ria_grp[s:e].tolist():
                    b = ((b * read_cnt + a) & 0xFFFFFFFF) % EC_FINGERPRINT_MOD
                fps.append((i, b))
            else:
                fps.append((i, -1))
        fps.sort(key=lambda p: (-p[1], p[0]))

        self.ec_to_alleles = []
        self.allele_ec[:] = -1
        if self.allele_cnt == 0 or fps[0][1] == -1:
            return
        for i, (allele_idx, fp) in enumerate(fps):
            if fp == -1:
                break
            new_ec = True
            match_j = -1
            for j in range(i - 1, -1, -1):
                if fps[j][1] != fp:
                    break
                if self._same_read_set(allele_idx, fps[j][0]):
                    new_ec = False
                    match_j = j
                    break
            if new_ec:
                self.ec_to_alleles.append([allele_idx])
                self.allele_ec[allele_idx] = len(self.ec_to_alleles) - 1
            else:
                ec = int(self.allele_ec[fps[match_j][0]])
                self.ec_to_alleles[ec].append(allele_idx)
                self.allele_ec[allele_idx] = ec

    def _same_read_set(self, a1: int, a2: int) -> bool:
        s1, e1 = int(self._ria_off[a1]), int(self._ria_off[a1 + 1])
        s2, e2 = int(self._ria_off[a2]), int(self._ria_off[a2 + 1])
        if e1 - s1 != e2 - s2:
            return False
        if not np.array_equal(self._ria_grp[s1:e1], self._ria_grp[s2:e2]):
            return False
        q = self._flat_qual
        r1 = self._grp_off[self._ria_grp[s1:e1]] + self._ria_pos[s1:e1]
        r2 = self._grp_off[self._ria_grp[s2:e2]] + self._ria_pos[s2:e2]
        return bool(np.array_equal(q[r1], q[r2]))

    def _remove_low_mapq(self) -> None:
        """Within each EC keep only alleles with the maximal summed read
        quality (Genotyper.hpp:1330-1368)."""
        qual_sum = np.zeros(self.allele_cnt, dtype=np.float64)
        np.add.at(qual_sum, self._flat_allele,
                  self._flat_qual.astype(np.float64))
        for i, alleles in enumerate(self.ec_to_alleles):
            mx = max(qual_sum[a] for a in alleles)
            self.ec_to_alleles[i] = [a for a in alleles if qual_sum[a] == mx]

    # ----------------------------------------------------------------- EM
    def _read_group_csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Read-group -> distinct EC ids (first-appearance order) and the
        per-group fragment count (max weight) — Genotyper.hpp:1150-1189."""
        off = self._grp_off
        G = len(off) - 1
        if G == 0:
            return (np.zeros(1, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.float64))
        # per-group max weight (float32 max, widened after — same value as
        # the sequential float() comparisons)
        counts = np.maximum.reduceat(self._flat_weight, off[:-1]).astype(
            np.float64)
        # distinct ECs per group in first-appearance order
        ec_cnt = len(self.ec_to_alleles)
        grp_of_row = np.repeat(np.arange(G, dtype=np.int64), np.diff(off))
        ec_row = self.allele_ec[self._flat_allele]
        key = grp_of_row * (ec_cnt + 1) + ec_row
        _, first = np.unique(key, return_index=True)
        first.sort()
        ecs = ec_row[first].astype(np.int32)
        offsets = np.zeros(G + 1, dtype=np.int64)
        np.cumsum(np.bincount(grp_of_row[first], minlength=G),
                  out=offsets[1:])
        return offsets, ecs, counts

    def quantify(self) -> int:
        """Run SQUAREM EM; returns iteration count (Genotyper.hpp:1142-1328)."""
        ec_cnt = len(self.ec_to_alleles)
        self._last_ec_read_count = np.zeros(ec_cnt, dtype=np.float64)
        if ec_cnt == 0:
            return 0
        rg_off, rg_ecs, rg_counts = self._read_group_csr()
        backend = self.cfg.em_backend
        if backend == "auto":
            backend = self._resolve_em_backend(len(rg_counts), ec_cnt)
        elif backend == "jax":
            from .pipeline import require_device
            require_device("--emBackend jax")
        self.last_em_route = backend
        if backend == "jax":
            from ..ops.em import em_quantify_jax
            iters, ec_read_count = em_quantify_jax(
                self.ec_to_alleles, (rg_off, rg_ecs), rg_counts,
                self.allele_eff_len, self.allele_missing, self.allele_weight,
                self.allele_gene, self.allele_major, self.gene_cnt,
                self.major_cnt, self.cfg.filter_frac,
                self.cfg.min_squarem_alpha, MAX_EM_ITERATIONS,
            )
            import jax as _jax
            if not _jax.config.read("jax_enable_x64"):
                # Exactness gate: the device trajectory ran in f32
                # (64-bit mode is off).  Polish with the native f64
                # SQUAREM warm-started from the device solution until the
                # reference's own convergence criterion (diffSum < 1e-5,
                # Genotyper.hpp:1289-1290) holds in f64 — the device does
                # the O(hundreds) of heavy iterations, the host does the
                # few cheap ones, and the final sufficient statistics sit
                # at the f64 fixed point the native route converges to.
                from ..native import em_quantify
                ec_len = np.array(
                    [min(int(self.allele_eff_len[a]) for a in alleles)
                     for alleles in self.ec_to_alleles], dtype=np.float64)
                per_len = ec_read_count / ec_len
                norm = per_len.sum()
                if norm > 0:
                    polish_iters, polished = em_quantify(
                        self.ec_to_alleles, (rg_off, rg_ecs), rg_counts,
                        self.allele_eff_len, self.allele_missing,
                        self.allele_weight, self.allele_gene,
                        self.allele_major, self.gene_cnt, self.major_cnt,
                        self.cfg.filter_frac, self.cfg.min_squarem_alpha,
                        MAX_EM_ITERATIONS, init_x=per_len / norm,
                    )
                    iters += polish_iters
                    ec_read_count = polished
        else:
            from ..native import em_quantify
            iters, ec_read_count = em_quantify(
                self.ec_to_alleles, (rg_off, rg_ecs), rg_counts,
                self.allele_eff_len, self.allele_missing, self.allele_weight,
                self.allele_gene, self.allele_major, self.gene_cnt,
                self.major_cnt, self.cfg.filter_frac,
                self.cfg.min_squarem_alpha, MAX_EM_ITERATIONS,
            )
        self._last_ec_read_count = ec_read_count
        self._set_allele_abundance(ec_read_count)
        return iters

    @staticmethod
    def _resolve_em_backend(rg_cnt: int, ec_cnt: int) -> str:
        """"auto" EM routing: the device EM at large shapes, the native
        f64 loop at small ones, where dispatch and transfer cost more
        than the few milliseconds the native loop takes — and the native
        path is the bit-exact oracle.  Routes to the device when a GPU is
        present and the dense incidence has >= 5e7 cells; the f64 host
        polish in quantify() then pins the result to the native fixed
        point."""
        import os

        env = os.environ.get("T1K_EM_BACKEND", "")
        if env in ("native", "jax"):
            return env
        if rg_cnt * max(ec_cnt, 1) < 5e7:
            return "native"
        # Past the dense-incidence memory budget the device would fall
        # back to the segment formulation, which "auto" does not take
        # (it stays the beyond-device-memory / multi-host sharded
        # formulation behind an explicit em_backend="jax").
        from ..ops.em import DENSE_EM_MAX_BYTES, DENSE_EM_MAX_ELEMS

        if rg_cnt * max(ec_cnt, 1) > min(DENSE_EM_MAX_ELEMS,
                                         DENSE_EM_MAX_BYTES):
            return "native"
        from .pipeline import device_present

        return "jax" if device_present() else "native"

    def set_em_result(self, iters: int, ec_read_count: np.ndarray) -> int:
        """Adopt externally computed EM sufficient statistics (the cohort
        driver's batched device EM; see ops/em.py
        em_quantify_jax_batched) in place of quantify()."""
        self._last_ec_read_count = np.asarray(ec_read_count, dtype=np.float64)
        if len(self.ec_to_alleles):
            self._set_allele_abundance(self._last_ec_read_count)
        return iters

    def em_problem(self):
        """This sample's EC problem in the form the ops.em quantifiers
        consume: (ec_to_alleles, rg_ecs_csr, rg_counts, allele_weight)."""
        rg_off, rg_ecs, rg_counts = self._read_group_csr()
        return self.ec_to_alleles, (rg_off, rg_ecs), rg_counts, self.allele_weight

    def save_em_state(self, path: str, ec_read_count: np.ndarray) -> None:
        """Checkpoint the EM sufficient statistics (preemption tolerance:
        a later run can resume allele selection from this file via
        load_em_state without re-running alignment or EM)."""
        np.savez_compressed(
            path,
            ec_read_count=ec_read_count,
            ec_first_allele=np.array([a[0] for a in self.ec_to_alleles],
                                     dtype=np.int64),
            ec_sizes=np.array([len(a) for a in self.ec_to_alleles],
                              dtype=np.int64),
            ec_alleles=np.array([a for lst in self.ec_to_alleles for a in lst],
                                dtype=np.int64),
        )

    def load_em_state(self, path: str) -> None:
        """Resume from a save_em_state snapshot: validates the EC
        structure of the snapshot against the current run (same reads +
        reference => same ECs), then restores the sufficient statistics
        without re-running EM."""
        data = np.load(path)
        first = np.array([a[0] for a in self.ec_to_alleles], dtype=np.int64)
        sizes = np.array([len(a) for a in self.ec_to_alleles], dtype=np.int64)
        flat = np.array([a for lst in self.ec_to_alleles for a in lst],
                        dtype=np.int64)
        if (len(data["ec_read_count"]) != len(first)
                or not np.array_equal(data["ec_first_allele"], first)
                or not np.array_equal(data["ec_sizes"], sizes)
                or not np.array_equal(data["ec_alleles"], flat)):
            raise ValueError(
                f"EM snapshot {path} was built from different equivalence "
                "classes (different reads or reference); cannot resume")
        self._last_ec_read_count = np.asarray(data["ec_read_count"],
                                              dtype=np.float64)
        self._set_allele_abundance(self._last_ec_read_count)

    def init_abundance_from_file(self, path: str) -> None:
        """Bypass EM with a kallisto-style abundance file
        (Genotyper.hpp:1016-1051)."""
        name_to_idx = self.refset.name_to_idx()
        self.abundance[:] = 0
        with open(path) as f:
            f.readline()
            for line in f:
                cols = line.split()
                if len(cols) < 5:
                    continue
                idx = name_to_idx.get(cols[0])
                if idx is not None:
                    self.abundance[idx] = float(cols[3])
        for alleles in self.ec_to_alleles:
            total = float(sum(self.abundance[a] for a in alleles))
            for a in alleles:
                self.ec_abundance_per_allele[a] = total
        self._set_allele_abundance(None)

    def _set_allele_abundance(self, ec_read_count: Optional[np.ndarray]) -> None:
        """FPK conversion + gene/major aggregates (Genotyper.hpp:957-1014)."""
        if ec_read_count is not None:
            self.abundance[:] = 0
            self.ec_abundance_per_allele[:] = 0
            for i, alleles in enumerate(self.ec_to_alleles):
                ec_len = min(int(self.allele_eff_len[a]) for a in alleles)
                abund = float(ec_read_count[i]) / ec_len * 1000.0
                for a in alleles:
                    self.abundance[a] = abund / len(alleles)
                    self.ec_abundance_per_allele[a] = abund
        self.major_abundance[:] = 0
        self.gene_abundance_arr[:] = 0
        self.gene_max_major[:] = 0
        for i in range(self.allele_cnt):
            self.major_abundance[self.allele_major[i]] += self.abundance[i]
            self.gene_abundance_arr[self.allele_gene[i]] += self.abundance[i]
        for i in range(self.allele_cnt):
            ab = self.major_abundance[self.allele_major[i]]
            if ab > self.gene_max_major[self.allele_gene[i]]:
                self.gene_max_major[self.allele_gene[i]] = ab

    # ------------------------------------------- likelihood-based pruning
    def remove_low_likelihood(self) -> None:
        """Prune EC members whose covered span is unlikely given the EC
        abundance (Genotyper.hpp:1371-1460).  Vectorized: the per-allele
        min-start / max-end over the representative's supporting reads is
        a scatter-min/max over the flattened group rows."""
        off = self._grp_off
        lut = np.full(self.allele_cnt, -1, dtype=np.int64)
        for i, alleles in enumerate(self.ec_to_alleles):
            al = np.asarray(alleles, dtype=np.int64)
            size = len(al)
            min_starts = self.allele_len[al].astype(np.int64)
            max_ends = np.full(size, -1, dtype=np.int64)
            lut[al] = np.arange(size)
            rep = alleles[0]
            s, e = int(self._ria_off[rep]), int(self._ria_off[rep + 1])
            if e > s:
                grp = self._ria_grp[s:e]
                cnts = off[grp + 1] - off[grp]
                total = int(cnts.sum())
                rows = (np.repeat(off[grp], cnts)
                        + np.arange(total, dtype=np.int64)
                        - np.repeat(np.cumsum(cnts) - cnts, cnts))
                slot = lut[self._flat_allele[rows]]
                m = slot >= 0
                sm = slot[m]
                np.minimum.at(min_starts, sm, self._flat_start[rows[m]])
                np.maximum.at(max_ends, sm, self._flat_end[rows[m]])
            lut[al] = -1
            ln = self.allele_len[al].astype(np.int64)
            eff = np.minimum(max_ends - min_starts + 1, ln)
            lls = (eff.astype(np.float64) / ln) ** \
                self.ec_abundance_per_allele[al]
            max_ll = lls.max(initial=-1.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                keep = (lls / max_ll >= EC_LIKELIHOOD_CUTOFF) | (lls == max_ll)
            self.ec_to_alleles[i] = [a for a, k in zip(alleles, keep) if k]

    # ----------------------------------------------------------- selection
    def select_alleles(self) -> None:
        """Greedy EC selection + pairwise allele-type re-ranking + quality
        (Genotyper.hpp:1462-2090)."""
        read_cnt = self.read_group_count
        read_covered = np.zeros(read_cnt, dtype=bool)
        self.selected_alleles = [[] for _ in range(self.gene_cnt)]
        cfg = self.cfg

        ec_cnt = len(self.ec_to_alleles)
        order = sorted(
            range(ec_cnt),
            key=lambda e: (-self.ec_abundance_per_allele[self.ec_to_alleles[e][0]], e),
        )

        filtered_alleles: List[int] = []
        for ec in order:
            alleles = self.ec_to_alleles[ec]
            allele_idx = alleles[0]
            if self.ec_abundance_per_allele[allele_idx] <= 1e-6:
                break

            covered = 0.0
            total_assigned = 0.0
            read_list = list(self._ria_pairs(allele_idx))
            for (ri, rj) in read_list:
                if self._flat_qual[self._grp_off[ri] + rj] != 1:
                    continue
                w = float(self._flat_weight[self._grp_off[ri]])
                if read_covered[ri]:
                    covered += w
                total_assigned += w

            genes_to_add: List[int] = []
            alleles_to_add: List[int] = []
            for a in alleles:
                g = int(self.allele_gene[a])
                filt = False
                ec_ab = self.ec_abundance_per_allele[a]
                major_ab = self.major_abundance[self.allele_major[a]]
                if (ec_ab < cfg.filter_frac * self.gene_max_major[g]
                        and (ec_ab * 3 >= major_ab
                             or major_ab < 3 * cfg.filter_frac * self.gene_max_major[g])):
                    filt = True
                if covered == total_assigned and (
                    ec_ab < 0.25 * self.gene_max_major[g]
                    or len(self.selected_alleles[g]) == 0
                    or ec_ab < 0.5 * self.ec_abundance_per_allele[self.selected_alleles[g][-1][0]]
                ):
                    filt = True
                if filt:
                    filtered_alleles.append(a)
                    continue
                if g not in genes_to_add:
                    genes_to_add.append(g)
                alleles_to_add.append(a)

            quality = 60
            if len(genes_to_add) > 1:
                quality = 0
            if genes_to_add:
                for (ri, rj) in read_list:
                    if self._flat_qual[self._grp_off[ri] + rj] == 1:
                        read_covered[ri] = True
            gene_allele_types: Dict[int, int] = {}
            for a in alleles_to_add:
                g = int(self.allele_gene[a])
                major = int(self.allele_major[a])
                rank = -1
                for (sa, sr) in self.selected_alleles[g]:
                    if int(self.allele_major[sa]) == major:
                        rank = sr
                        break
                if rank == -1:
                    if g in gene_allele_types:
                        rank = gene_allele_types[g]
                    else:
                        rank = self.gene_allele_type_cnt(g)
                        gene_allele_types[g] = rank
                self.genotype_quality[a] = quality
                self.allele_rank[a] = rank
                ec_ab = self.ec_abundance_per_allele[a]
                major_ab = self.major_abundance[self.allele_major[a]]
                if (ec_ab < cfg.filter_frac * self.gene_max_major[g]
                        and (ec_ab * 3 >= major_ab
                             or major_ab < 3 * cfg.filter_frac * self.gene_max_major[g])):
                    self.genotype_quality[a] = 0
                self.selected_alleles[g].append([a, rank])

        # Rescue filtered alleles whose major-allele series was selected
        # (Genotyper.hpp:1670-1695).
        for a in filtered_alleles:
            g = int(self.allele_gene[a])
            if not self.selected_alleles[g]:
                continue
            rank = -1
            for (sa, sr) in self.selected_alleles[g]:
                if int(self.allele_major[sa]) == int(self.allele_major[a]):
                    rank = sr
                    break
            if rank != -1:
                self.selected_alleles[g].append([a, rank])

        self._pairwise_rerank(read_cnt)
        self._compute_quality()

    def gene_allele_type_cnt(self, g: int) -> int:
        if not self.selected_alleles[g]:
            return 0
        return max(sr for (_, sr) in self.selected_alleles[g]) + 1

    def _pairwise_rerank(self, read_cnt: int) -> None:
        """Iterative (type-j, type-k) best-pair search per gene with
        missing-coverage weights (Genotyper.hpp:1697-1996)."""
        read_coverage = np.zeros(read_cnt, dtype=np.int64)
        used_ec: Dict[int, int] = {}
        total_covered = 0
        for g in range(self.gene_cnt):
            for (a, r) in self.selected_alleles[g]:
                if r > 1:
                    continue
                ec = int(self.allele_ec[a])
                if ec in used_ec:
                    continue
                used_ec[ec] = 1
                for (ri, rj) in self._ria_pairs(a):
                    if self._flat_qual[self._grp_off[ri] + rj] != 1:
                        continue
                    if read_coverage[ri] == 0:
                        total_covered += 1
                    read_coverage[ri] += 1

        # Per gene: map missingCoverage value -> max abundance among its
        # allele types (Genotyper.hpp:1731-1770).
        missing_weight: List[Dict[int, float]] = []
        for g in range(self.gene_cnt):
            weight: Dict[int, float] = {}
            type_cnt = self.gene_allele_type_cnt(g)
            info = [[-1, 0.0] for _ in range(type_cnt)]
            for (a, r) in self.selected_alleles[g]:
                info[r][1] += self.abundance[a]
                if info[r][0] == -1 or int(self.allele_missing[a]) < info[r][0]:
                    info[r][0] = int(self.allele_missing[a])
            for j in range(type_cnt):
                if info[j][0] not in weight or weight[info[j][0]] < info[j][1]:
                    weight[info[j][0]] = info[j][1]
            missing_weight.append(weight)

        for _ in range(1000):
            updated = 0
            for g in range(self.gene_cnt):
                type_cnt = self.gene_allele_type_cnt(g)
                if type_cnt <= 2:
                    continue
                sel = self.selected_alleles[g]
                sel_cnt = len(sel)
                best_types: List[Tuple[int, int]] = []
                max_cover = 0.0
                max_cover_ab = 0.0
                allele_j = allele_k = 0

                # remove this gene's current contribution
                used_ec = {}
                for (a, r) in sel:
                    if r > 1:
                        continue
                    ec = int(self.allele_ec[a])
                    if ec in used_ec:
                        continue
                    used_ec[ec] = 1
                    for (ri, rj) in self._ria_pairs(a):
                        if self._flat_qual[self._grp_off[ri] + rj] == 1:
                            read_coverage[ri] -= 1

                j = 0
                while j < type_cnt - 1 and j <= 1:
                    used_ec = {}
                    covered_from_a: Dict[int, int] = {}
                    for l in range(sel_cnt):
                        if sel[l][1] != j:
                            continue
                        a = sel[l][0]
                        ec = int(self.allele_ec[a])
                        if ec in used_ec:
                            continue
                        used_ec[ec] = 1
                        for (ri, rj) in self._ria_pairs(a):
                            if (read_coverage[ri] == 0
                                    and self._flat_qual[self._grp_off[ri] + rj] == 1):
                                covered_from_a[ri] = covered_from_a.get(ri, 0) | 1
                        allele_j = l
                    for k in range(j + 1, type_cnt):
                        covered = dict(covered_from_a)
                        for l in range(sel_cnt):
                            if sel[l][1] != k:
                                continue
                            a = sel[l][0]
                            ec = int(self.allele_ec[a])
                            if ec in used_ec:
                                continue
                            used_ec[ec] = 1
                            for (ri, rj) in self._ria_pairs(a):
                                if (read_coverage[ri] == 0
                                        and self._flat_qual[self._grp_off[ri] + rj] == 1):
                                    covered[ri] = covered.get(ri, 0) | 2
                            allele_k = l

                        ab_j = ab_k = 0.0
                        j_missing = k_missing = -1
                        for l in range(sel_cnt):
                            a = sel[l][0]
                            if sel[l][1] == j:
                                ab_j += self.abundance[a]
                                if j_missing == -1 or int(self.allele_missing[a]) < j_missing:
                                    j_missing = int(self.allele_missing[a])
                            elif sel[l][1] == k:
                                ab_k += self.abundance[a]
                                if k_missing == -1 or int(self.allele_missing[a]) < k_missing:
                                    k_missing = int(self.allele_missing[a])
                        ab_sum = ab_j * ab_k

                        covered_cnt = 0.0
                        for ri in sorted(covered.keys()):
                            covered_cnt += float(self._flat_adjust[self._grp_off[ri]])

                        if type_cnt > 3 or j_missing >= 10 or k_missing >= 10:
                            wj = missing_weight[g].get(j_missing, 0.0)
                            wk = missing_weight[g].get(k_missing, 0.0)
                            if type_cnt <= 3:
                                if wj >= 1:
                                    wj = math.log(wj) / math.log(10.0)
                                if wk >= 1:
                                    wk = math.log(wk) / math.log(10.0)
                            covered_cnt = (
                                covered_cnt
                                - j_missing * wj * self.cfg.read_length / 150.0
                                - k_missing * wk * self.cfg.read_length / 150.0
                                + float(self.allele_weight[sel[allele_j][0]])
                            )

                        if (not best_types or covered_cnt > max_cover
                                or (covered_cnt == max_cover and ab_sum > max_cover_ab)):
                            max_cover = covered_cnt
                            max_cover_ab = ab_sum
                            best_types = [(j, k)]
                        elif covered_cnt == max_cover:
                            best_types.append((j, k))
                    j += 1

                bt = best_types[0]
                if bt != (0, 1):
                    updated += 1
                    for l in range(sel_cnt):
                        r = sel[l][1]
                        if r == bt[0]:
                            nr = 0
                        elif r == bt[1]:
                            nr = 1
                        elif r < bt[0]:
                            nr = r + 2
                        elif r < bt[1]:
                            nr = r + 1
                        else:
                            continue
                        sel[l][1] = nr
                        self.allele_rank[sel[l][0]] = nr

                # restore coverage
                used_ec = {}
                for (a, r) in sel:
                    if r > 1:
                        continue
                    ec = int(self.allele_ec[a])
                    if ec in used_ec:
                        continue
                    used_ec[ec] = 1
                    for (ri, rj) in self._ria_pairs(a):
                        if self._flat_qual[self._grp_off[ri] + rj] == 1:
                            read_coverage[ri] += 1
            if updated == 0:
                break

    def _compute_quality(self) -> None:
        """Statistical genotype quality per allele type
        (Genotyper.hpp:2010-2085)."""
        gene_abundances = np.zeros(self.gene_cnt, dtype=np.float64)
        for g in range(self.gene_cnt):
            for (a, _) in self.selected_alleles[g]:
                gene_abundances[g] += self.abundance[a]

        sim = self.refset.gene_similarity
        for g in range(self.gene_cnt):
            rank_cnt = self.gene_allele_type_cnt(g)
            rank_abund = [0.0] * rank_cnt
            for (a, r) in self.selected_alleles[g]:
                rank_abund[r] += self.abundance[a]
            cross_gene_noise = 0.0
            for g2 in range(self.gene_cnt):
                if g2 == g:
                    continue
                cross_gene_noise += (self.cfg.cross_gene_rate * sim[g2][g]
                                     * gene_abundances[g2])
            for r in range(rank_cnt):
                null_mean = ((gene_abundances[g] - rank_abund[r]) * CROSS_ALLELE_RATE
                             + cross_gene_noise)
                score = 0.0
                if rank_abund[r]:
                    tail = alnorm(2 * (math.sqrt(rank_abund[r]) - math.sqrt(null_mean)), True)
                    # C log(0) = -inf -> score clamps to the max quality
                    score = math.inf if tail == 0.0 else -math.log(tail) / math.log(10.0)
                if score > MAX_QUALITY:
                    score = MAX_QUALITY
                if score < 0:
                    score = 0
                if rank_abund[r] < self.cfg.filter_cov:
                    score = 0
                for (a, rr) in self.selected_alleles[g]:
                    if rr == r and self.genotype_quality[a] > 0:
                        self.genotype_quality[a] = int(score)

    # ------------------------------------------------------------- output
    def allele_description(self, g: int) -> Tuple[int, str, str, str]:
        """Format one gene's genotype row fields
        (Genotyper.hpp:2103-2178)."""
        used = np.zeros(self.major_cnt, dtype=bool)
        qualities = [-1, -1]
        type_cnt = max(self.gene_allele_type_cnt(g), 2)
        buffers = ["", "", ""]
        ret = 0
        sep = "\t"
        for t in range(type_cnt):
            abundance = 0.0
            bi = t if t <= 1 else 2
            if t > 1:
                sep = ";"
            # the per-type buffer is cleared on entry — for t > 1 each later
            # type overwrites the secondary field (reference
            # Genotyper.hpp:2134 clears the shared buffer every round)
            buf = ""
            added = False
            local_qual = -1
            if t == 1 and qualities[0] == 0:
                used[:] = False
            for (a, r) in self.selected_alleles[g]:
                if r != t:
                    continue
                major = int(self.allele_major[a])
                abundance += self.abundance[a]
                if not used[major]:
                    local_qual = int(self.genotype_quality[a])
                    if t <= 1:
                        ret = t + 1
                    name = self.refset.major_allele_names[major]
                    if added:
                        buf += "," + name
                    else:
                        buf = name if buf == "" else buf + "|" + name
                        added = True
                    used[major] = True
            if local_qual >= 0:
                buf += f"{sep}{abundance:.6f}{sep}{local_qual}"
            elif t <= 1:
                buf += ".\t0\t-1"
            if t <= 1:
                qualities[t] = local_qual
            buffers[bi] = buf
        return ret, buffers[0], buffers[1], buffers[2]

    def write_genotype_tsv(self, path: str) -> None:
        with open(path, "w") as f:
            for g in range(self.gene_cnt):
                cnt, a1, a2, secondary = self.allele_description(g)
                f.write(f"{self.refset.gene_names[g]}\t{cnt}\t{a1}\t{a2}\t{secondary}\n")

    def representative_alleles(self) -> List[Tuple[str, int]]:
        """Top allele per called type, for the post-analysis stage
        (Genotyper.hpp:2180-2229)."""
        from ..io.refset import parse_allele_name

        out = []
        for g in range(self.gene_cnt):
            reps = [-1, -1]
            for (a, r) in self.selected_alleles[g]:
                if r > 1 or self.genotype_quality[a] < 1:
                    continue
                if (reps[r] == -1
                        or self.ec_abundance_per_allele[reps[r]] < self.ec_abundance_per_allele[a]
                        or (self.ec_abundance_per_allele[reps[r]] == self.ec_abundance_per_allele[a]
                            and reps[r] > a)):
                    reps[r] = a
            if reps[1] == -1 and reps[0] != -1:
                mx = -1.0
                mx_a = -1
                rep0_name = self.refset.alleles[reps[0]].name
                _, rep0_exon = parse_allele_name(
                    rep0_name, self.refset.digit_units, self.refset.delimiter, fields_type=1)
                for (a, r) in self.selected_alleles[g]:
                    if r != 0 or self.allele_ec[a] == self.allele_ec[reps[0]]:
                        continue
                    _, a_exon = parse_allele_name(
                        self.refset.alleles[a].name, self.refset.digit_units,
                        self.refset.delimiter, fields_type=1)
                    if a_exon == rep0_exon:
                        continue
                    if (self.ec_abundance_per_allele[a] > mx
                            or (self.ec_abundance_per_allele[a] == mx and a < mx_a)):
                        mx = self.ec_abundance_per_allele[a]
                        mx_a = a
                if mx != -1:
                    reps[1] = mx_a
            for r in range(2):
                if reps[r] != -1:
                    out.append((self.refset.alleles[reps[r]].name,
                                int(self.genotype_quality[reps[r]])))
        return out


def compute_missing_coverage(refset, packed, pos_weight: np.ndarray,
                             ratio: float = 0.01) -> np.ndarray:
    """Count exon positions whose matched-base coverage falls below
    ratio x median (min 1) — reference SeqSet.hpp:2717-2755."""
    out = np.zeros(len(refset), dtype=np.int32)
    for idx, a in enumerate(refset.alleles):
        st = int(packed.seq_starts[idx])
        ln = int(packed.seq_lens[idx])
        mask = a.exon_mask
        codes = a.codes
        # gather the coverage of the reference base at each position
        pw = pos_weight[st:st + ln]
        base = np.minimum(codes[:ln], 3).astype(np.int64)
        cov = pw[np.arange(ln), base]
        cov = np.where(codes[:ln] < 4, cov, 0)
        exon_cov = np.sort(cov[mask[:ln]])
        k = len(exon_cov)
        if k == 0:
            out[idx] = 0
            continue
        cutoff = exon_cov[k // 2] * ratio
        if cutoff < 1:
            cutoff = 1
        out[idx] = int(np.searchsorted(exon_cov, cutoff, side="left"))
    return out
