"""Inverted-file keyframe database for loop / relocalization candidates.

Host-side (pointer-chasing) replacement for KeyFrameDatabase.py: word ->
keyframe inverted index, shared-word counting with the 0.8*max cut, BoW
L1 scoring, and covisibility-group score accumulation with the 0.75*best
retain rule (detect_loop_candidates:30-94 and
detect_relocalization_candidates:96-159).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set

from pyorbslam_jax.place.vocabulary import Vocabulary


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary):
        self.voc = voc
        self.inverted: Dict[int, List[int]] = defaultdict(list)
        self.bow: Dict[int, Dict[int, float]] = {}

    def add(self, kf: int, bow: Dict[int, float]):
        self.bow[kf] = bow
        for w in bow:
            self.inverted[w].append(kf)

    def erase(self, kf: int):
        bow = self.bow.pop(kf, None)
        if bow is None:
            return
        for w in bow:
            lst = self.inverted.get(w)
            if lst and kf in lst:
                lst.remove(kf)

    def clear(self):
        self.inverted.clear()
        self.bow.clear()

    def _candidates(
        self,
        query_bow: Dict[int, float],
        exclude: Set[int],
        min_score: Optional[float],
        covis_neighbors,
    ) -> List[int]:
        # 1. shared-word counting
        words: Dict[int, int] = defaultdict(int)
        for w in query_bow:
            for kf in self.inverted.get(w, ()):  # noqa: B905
                if kf not in exclude:
                    words[kf] += 1
        if not words:
            return []
        max_common = max(words.values())
        min_common = int(max_common * 0.8)

        # 2. direct BoW scores
        scored: List = []
        scores: Dict[int, float] = {}
        for kf, n in words.items():
            if n > min_common:
                s = Vocabulary.score(query_bow, self.bow[kf])
                scores[kf] = s
                if min_score is None or s >= min_score:
                    scored.append((s, kf))
        if not scored:
            return []

        # 3. covisibility-group accumulation
        acc: List = []
        best_acc = min_score if min_score is not None else 0.0
        for s, kf in scored:
            acc_score = s
            best_score = s
            best_kf = kf
            for nb in covis_neighbors(kf, 10):
                if nb in words and words[nb] > min_common and nb in scores:
                    acc_score += scores[nb]
                    if scores[nb] > best_score:
                        best_score = scores[nb]
                        best_kf = nb
            acc.append((acc_score, best_kf))
            best_acc = max(best_acc, acc_score)

        retain = 0.75 * best_acc
        out: List[int] = []
        seen: Set[int] = set()
        for a, kf in acc:
            if a > retain and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out

    def detect_loop_candidates(
        self, kf: int, query_bow: Dict[int, float], min_score: float,
        connected: Set[int], covis_neighbors,
    ) -> List[int]:
        exclude = set(connected) | {kf}
        return self._candidates(query_bow, exclude, min_score, covis_neighbors)

    def detect_relocalization_candidates(
        self, query_bow: Dict[int, float], covis_neighbors,
    ) -> List[int]:
        return self._candidates(query_bow, set(), None, covis_neighbors)
