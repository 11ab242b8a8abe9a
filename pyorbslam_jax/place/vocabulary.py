"""DBoW2-style binary vocabulary as flat arrays + batched device descent.

Replaces pyDBoW (TemplatedVocabulary.py / FORB.py / ScoringObject.py):

  * the k-ary tree is stored level-contiguous in flat arrays
    (node descriptors, child ranges, leaf weights/word-ids);
  * ``transform`` — the hot path, called per frame/keyframe — descends all
    N descriptors in parallel on device: each level is one batched
    Hamming argmin against gathered child descriptors
    (TemplatedVocabulary.transform:108-161 semantics, including the
    node-at-level-(L-levels_up) FeatureVector output);
  * ORBvoc.txt text format is read/written for parity
    (load_from_text_file:43-81: header "k L scoring weighting", then per
    node "parent is_leaf d0..d31 weight");
  * since no ORBvoc.txt ships with this machine, :func:`train` builds a
    vocabulary by k-majority binary k-means over sample descriptors —
    the same construction DBoW2 uses (FORB.meanValue bitwise majority).

Scoring is L1 (ScoringObject.py:7-28): s(v, w) = 2 + sum(|v-w| - |v| - |w|)
over common words, with both vectors L1-normalized.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.ops.hamming import hamming_matrix


def _pack_u32(bytes_arr: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 8) uint32 little-endian (matches the
    descriptor packing in ops/orb_descriptor.py)."""
    return bytes_arr.reshape(-1, 8, 4).astype(np.uint32) @ np.array(
        [1, 1 << 8, 1 << 16, 1 << 24], np.uint32
    )


def _unpack_u8(desc: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 32) uint8."""
    out = np.zeros((len(desc), 32), np.uint8)
    for b in range(4):
        out[:, b::4] = ((desc >> (8 * b)) & 0xFF).astype(np.uint8)
    return out


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


@dataclasses.dataclass
class Vocabulary:
    k: int
    L: int
    node_desc: np.ndarray     # (M, 8) uint32, node 0 = root (descriptor unused)
    child_start: np.ndarray   # (M,) int32 (0 = leaf)
    n_children: np.ndarray    # (M,) int32
    weight: np.ndarray        # (M,) float32 (leaves: idf weight)
    word_id: np.ndarray       # (M,) int32 (-1 for internal nodes)
    n_words: int = 0

    def __post_init__(self):
        if self.n_words == 0:
            self.n_words = int((self.word_id >= 0).sum())
        self._device = None

    @property
    def feature_levels_up(self) -> int:
        """levels_up placing the FeatureVector node at depth 2 (k^2
        buckets) — the granularity DBoW2's ORBvoc gives BoW-guided
        matching (k=10, L=6, levels_up=4 -> nodes two descents from the
        root).  In :func:`_transform_jit` the recorded node sits at
        depth (L - levels_up) + 1, so depth 2 needs levels_up = L - 1."""
        return max(self.L - 1, 1)

    # ---------------- transform (device) ----------------

    def _device_arrays(self):
        if self._device is None:
            self._device = (
                jnp.asarray(self.node_desc),
                jnp.asarray(self.child_start),
                jnp.asarray(self.n_children),
                jnp.asarray(self.weight),
                jnp.asarray(self.word_id),
            )
        return self._device

    def transform(
        self, desc: jnp.ndarray, levels_up: int = 4
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """desc (N, 8) uint32 -> (word_id (N,), word_weight (N,),
        feat_node (N,)) as numpy.  feat_node is the tree node at depth
        L - levels_up (the FeatureVector grouping key)."""
        nd, cs, nc, w, wid = self._device_arrays()
        packed = _transform_packed_jit(
            jnp.asarray(desc), nd, cs, nc, w, wid, self.k, self.L, levels_up
        )
        # one device->host transfer for all outputs
        out = np.asarray(packed)
        n = desc.shape[0]
        return out[:n], out[n: 2 * n].view(np.float32), out[2 * n:]

    def bow_vector(self, word: np.ndarray, weight: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> Dict[int, float]:
        """L1-normalized TF-IDF bag of words (BowVector.add_weight +
        normalize)."""
        bow: Dict[int, float] = {}
        n = len(word)
        for i in range(n):
            if valid is not None and not valid[i]:
                continue
            wd = int(word[i])
            if wd < 0 or weight[i] <= 0:
                continue
            bow[wd] = bow.get(wd, 0.0) + float(weight[i])
        s = sum(bow.values())
        if s > 0:
            for k_ in bow:
                bow[k_] /= s
        return bow

    @staticmethod
    def score(a: Dict[int, float], b: Dict[int, float]) -> float:
        """L1 score in [0, 1] (ScoringObject.py L1Scoring: for common words
        accumulate |vi - wi| - |vi| - |wi|, then s = -sum/2)."""
        acc = 0.0
        for k_, vi in a.items():
            wi = b.get(k_)
            if wi is not None:
                acc += abs(vi - wi) - abs(vi) - abs(wi)
        return -acc / 2.0

    # ---------------- IO ----------------

    def save_text(self, path: str):
        """ORBvoc.txt-compatible writer (one node per line, preorder by
        index; root excluded as in DBoW2)."""
        parent = np.full(len(self.node_desc), -1, np.int64)
        for i in range(len(self.node_desc)):
            if self.child_start[i] > 0:
                for c in range(self.n_children[i]):
                    parent[self.child_start[i] + c] = i
        u8 = _unpack_u8(self.node_desc)
        with open(path, "w") as f:
            f.write(f"{self.k} {self.L} 0 0\n")
            for i in range(1, len(self.node_desc)):
                is_leaf = 1 if self.child_start[i] == 0 else 0
                dbytes = " ".join(str(int(v)) for v in u8[i])
                f.write(f"{parent[i]} {is_leaf} {dbytes} {self.weight[i]:.6f}\n")

    @staticmethod
    def load_text(path: str) -> "Vocabulary":
        """Parse the ORBvoc.txt format (TemplatedVocabulary.
        load_from_text_file:43-81)."""
        with open(path) as f:
            header = f.readline().split()
            k, L = int(header[0]), int(header[1])
            rows = []
            for line in f:
                p = line.split()
                if len(p) < 35:
                    continue
                rows.append(
                    (int(p[0]), int(p[1]),
                     np.array([int(x) for x in p[2:34]], np.uint8),
                     float(p[34]))
                )
        m = len(rows) + 1
        node_desc = np.zeros((m, 8), np.uint32)
        child_start = np.zeros(m, np.int32)
        n_children = np.zeros(m, np.int32)
        weight = np.zeros(m, np.float32)
        word_id = np.full(m, -1, np.int32)
        # children of each parent are contiguous in file order (DBoW2
        # writes them that way)
        next_word = 0
        for i, (parent, is_leaf, dbytes, w) in enumerate(rows, start=1):
            node_desc[i] = _pack_u32(dbytes[None])[0]
            weight[i] = w
            pid = parent  # node ids are 0-based with root = 0 (loader parity)
            if child_start[pid] == 0:
                child_start[pid] = i
            n_children[pid] += 1
            if is_leaf:
                word_id[i] = next_word
                next_word += 1
        return Vocabulary(
            k=k, L=L, node_desc=node_desc, child_start=child_start,
            n_children=n_children, weight=weight, word_id=word_id,
            n_words=next_word,
        )


@functools.partial(jax.jit, static_argnames=("k", "L", "levels_up"))
def _transform_packed_jit(desc, node_desc, child_start, n_children, weight,
                          word_id, k: int, L: int, levels_up: int):
    """:func:`_transform_jit` with the three outputs packed into one int32
    buffer [word N | weight-bits N | node N] for a single host read."""
    word, w, node = _transform_jit.__wrapped__(
        desc, node_desc, child_start, n_children, weight, word_id,
        k, L, levels_up,
    )
    return jnp.concatenate([
        word.astype(jnp.int32),
        jax.lax.bitcast_convert_type(w.astype(jnp.float32), jnp.int32),
        node.astype(jnp.int32),
    ])


@functools.partial(jax.jit, static_argnames=("k", "L", "levels_up"))
def _transform_jit(desc, node_desc, child_start, n_children, weight, word_id,
                   k: int, L: int, levels_up: int):
    """Vectorized tree descent: for each of N descriptors, L levels of
    k-way Hamming argmin."""
    n = desc.shape[0]
    cur = jnp.zeros(n, jnp.int32)
    feat_node = jnp.zeros(n, jnp.int32)
    stop_level = max(L - levels_up, 0)
    for level in range(L):
        base = child_start[cur]                       # (N,)
        offsets = jnp.arange(k, dtype=jnp.int32)
        cand = base[:, None] + offsets[None, :]       # (N, k)
        valid = offsets[None, :] < n_children[cur][:, None]
        cand_safe = jnp.where(valid, cand, 0)
        cd = node_desc[cand_safe]                     # (N, k, 8)
        x = cd ^ desc[:, None, :]
        dist = jax.lax.population_count(x).astype(jnp.int32).sum(-1)  # (N, k)
        dist = jnp.where(valid, dist, 10_000)
        best = jnp.argmin(dist, axis=1)
        nxt = jnp.take_along_axis(cand_safe, best[:, None], 1)[:, 0]
        # leaves reached early (ragged trees) stay put
        has_children = n_children[cur] > 0
        cur = jnp.where(has_children, nxt, cur)
        if level == stop_level:
            feat_node = cur
    return word_id[cur], weight[cur], feat_node


_POPLUT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint8)


def _hamming_u8(a_u8: np.ndarray, centers_u8: np.ndarray,
                chunk: int = 1 << 15) -> np.ndarray:
    """(N, 32) u8 x (k, 32) u8 -> (N, k) int32 Hamming, LUT + chunks."""
    out = np.empty((len(a_u8), len(centers_u8)), np.int32)
    for i in range(0, len(a_u8), chunk):
        x = a_u8[i: i + chunk, None, :] ^ centers_u8[None, :, :]
        out[i: i + chunk] = _POPLUT[x].sum(-1, dtype=np.int32)
    return out


def train(
    descriptors: np.ndarray, k: int = 10, L: int = 4, seed: int = 0,
    max_iters: int = 8,
) -> Vocabulary:
    """k-majority binary k-means vocabulary training (DBoW2 construction:
    recursive k-means with bitwise-majority centroids, FORB.meanValue)."""
    rng = np.random.default_rng(seed)
    u8 = _unpack_u8(descriptors.astype(np.uint32))

    nodes_desc: List[np.ndarray] = [np.zeros(8, np.uint32)]
    child_start: List[int] = [0]
    n_children: List[int] = [0]

    def majority(rows_u8: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(rows_u8, axis=1, bitorder="little")
        return np.packbits((bits.mean(0) >= 0.5).astype(np.uint8),
                           bitorder="little")

    def kmeans(idx: np.ndarray) -> List[np.ndarray]:
        """Cluster u8[idx] into <= k groups; returns index groups."""
        if len(idx) <= k:
            return [np.array([i]) for i in idx]
        centers = u8[rng.choice(idx, k, replace=False)].copy()
        rows = u8[idx]
        a = None
        for _ in range(max_iters):
            d = _hamming_u8(rows, centers)
            a_new = d.argmin(1)
            if a is not None and (a_new == a).all():
                break
            a = a_new
            for c in range(k):
                members = rows[a == c]
                if len(members):
                    centers[c] = majority(members)
        return [idx[a == c] for c in range(k) if (a == c).any()]

    # BFS construction
    queue: List[Tuple[int, np.ndarray, int]] = [(0, np.arange(len(u8)), 0)]
    while queue:
        node, idx, level = queue.pop(0)
        if level == L or len(idx) == 0:
            continue
        groups = kmeans(idx)
        child_start[node] = len(nodes_desc)
        n_children[node] = len(groups)
        for g in groups:
            centroid = _pack_u32(majority(u8[g])[None])[0]
            child = len(nodes_desc)
            nodes_desc.append(centroid)
            child_start.append(0)
            n_children.append(0)
            if level + 1 < L:
                queue.append((child, g, level + 1))

    m = len(nodes_desc)
    node_desc = np.stack(nodes_desc)
    cs = np.array(child_start, np.int32)
    nc = np.array(n_children, np.int32)
    word_id = np.full(m, -1, np.int32)
    leaves = np.nonzero((cs == 0) & (np.arange(m) > 0))[0]
    word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
    # uniform idf weights until set_idf_weights is called with a corpus
    # (the reference's TF_IDF weights come from its training corpus)
    weight = np.where(word_id >= 0, 1.0, 0.0).astype(np.float32)
    return Vocabulary(
        k=k, L=L, node_desc=node_desc, child_start=cs, n_children=nc,
        weight=weight, word_id=word_id, n_words=len(leaves),
    )


def set_idf_weights(voc: Vocabulary, docs: List[np.ndarray]) -> None:
    """Corpus idf per word: w_i = log(N_docs / n_i), n_i = #documents
    containing word i (TemplatedVocabulary.create weighting=TF_IDF).
    ``docs``: list of (N, 8) uint32 descriptor arrays, one per document
    (training frame)."""
    n_docs = len(docs)
    counts = np.zeros(voc.n_words, np.int64)
    for d in docs:
        if len(d) == 0:
            continue
        word, _, _ = voc.transform(np.asarray(d, np.uint32))
        word = word[word >= 0]
        counts[np.unique(word)] += 1
    idf = np.where(counts > 0, np.log(n_docs / np.maximum(counts, 1)), 0.0)
    leaf = voc.word_id >= 0
    voc.weight[leaf] = idf[voc.word_id[leaf]].astype(np.float32)
    voc._device = None   # re-upload with the new weights


def save_npz(voc: Vocabulary, path: str) -> None:
    np.savez_compressed(
        path, k=voc.k, L=voc.L, node_desc=voc.node_desc,
        child_start=voc.child_start, n_children=voc.n_children,
        weight=voc.weight, word_id=voc.word_id)


def load_npz(path: str) -> Vocabulary:
    d = np.load(path)
    return Vocabulary(
        k=int(d["k"]), L=int(d["L"]), node_desc=d["node_desc"],
        child_start=d["child_start"], n_children=d["n_children"],
        weight=d["weight"], word_id=d["word_id"])


def load_default() -> Optional[Vocabulary]:
    """The vocabulary asset shipped with the package (trained offline by
    tools/train_vocab.py), or None when absent."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", "orb_vocab.npz")
    if not os.path.exists(path):
        return None
    return load_npz(path)
