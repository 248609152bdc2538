"""Batch-matrix Merkle commitments with single-field-element digests; port of
``linea_stark_tpu/merkle/mmcs.py`` for single-height commitments.

Leaf j hashes row j of every committed matrix (columns concatenated in
matrix order) with the hasher (Poseidon2's rate-2 sponge or Keccak-256);
each level above compresses adjacent pairs,
``level[k+1][j] = compress(level[k][2j], level[k][2j+1])``.  Levels stay in
natural order on the device (one K4 ``merkle_level`` or K5 launch each);
the reference's bit-reversed subtree buffer existed to bound TPU compile
time and changes neither roots nor openings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..field import fr
from ..hash import poseidon2 as p2
from ..hash.hasher import KeccakHasher, make_hasher


@dataclass
class MerkleTree:
    """Prover-side commitment: retained matrices + every digest level."""

    matrices: list          # (8, W_k, N) each, one height
    levels: list            # levels[0] = (8, N) leaf digests, ..., (8, 1)
    hasher: object
    root_cache: int = None  # canonical root when a host build already has it

    def root_int(self) -> int:
        if self.root_cache is None:
            self.root_cache = fr.unpack_ints(self.levels[-1][:, :1])[0]
        return self.root_cache


def build_levels(d: torch.Tensor, h) -> list:
    """Every digest level above a (8, N) leaf layer, leaves first."""
    levels = [d]
    while d.shape[-1] > 1:
        d = h.merkle_level(d)
        levels.append(d)
    return levels


def commit(matrices: Sequence[torch.Tensor], hasher=None) -> MerkleTree:
    """Commit to matrices (8, W_k, N) of one common power-of-two height."""
    h = make_hasher(hasher if hasher is not None else p2.DEFAULT_PARAMS)
    assert len(matrices) >= 1
    heights = {m.shape[2] for m in matrices}
    if len(heights) != 1:
        raise NotImplementedError("multi-height commitments are not ported")
    (height,) = heights
    assert height & (height - 1) == 0, "heights must be powers of two"
    if len(matrices) == 1:
        d = h.hash_matrix(matrices[0])
    else:
        d = h.hash_columns([m[:, c] for m in matrices for c in range(m.shape[1])])
    return MerkleTree(list(matrices), build_levels(d, h), h)


@dataclass
class BatchOpening:
    """Opened rows + authentication path for one leaf index.

    ``rows[k]`` are the canonical int values of matrix k's row at ``index``;
    ``siblings`` are the level sibling digests bottom-up."""

    index: int
    rows: list          # list (matrix order as committed) of list[int]
    siblings: list      # list[int], length log2(height)


def open_batch(requests) -> list:
    """Open several trees, each at its own index list.  ``requests``:
    [(MerkleTree, [indices])].  All row and sibling gathers run on each
    tree's device and come back in one host transfer; returns one list of
    :class:`BatchOpening` per request."""
    pieces = []  # (8, k) int32 CPU tensors, concatenated for one unpack
    offset = 0
    meta = []
    for tree, indices in requests:
        q = len(indices)
        height = tree.matrices[0].shape[2]
        log_h = height.bit_length() - 1
        idx_np = np.asarray(indices, dtype=np.int64)
        row_slots = []
        for m in tree.matrices:
            idx = torch.as_tensor(idx_np, device=m.device)
            rows = m.index_select(2, idx)  # (8, W, q)
            pieces.append(rows.reshape(8, -1))
            row_slots.append((offset, m.shape[1]))
            offset += m.shape[1] * q
        sib_off = offset
        cur = idx_np.copy()
        for lvl in range(log_h):
            lev = tree.levels[lvl]
            s = torch.as_tensor(cur ^ 1, device=lev.device)
            pieces.append(lev.index_select(1, s))
            offset += q
            cur >>= 1
        meta.append((list(indices), row_slots, sib_off, log_h))
    vals = (
        fr.unpack_ints(torch.cat([p.cpu() for p in pieces], dim=1))
        if pieces else []
    )
    out = []
    for indices, row_slots, sib_off, log_h in meta:
        q = len(indices)
        openings = []
        for qi, index in enumerate(indices):
            rows = [
                [vals[off + c * q + qi] for c in range(w)] for off, w in row_slots
            ]
            sibs = [vals[sib_off + lvl * q + qi] for lvl in range(log_h)]
            openings.append(BatchOpening(int(index), rows, sibs))
        out.append(openings)
    return out


def open_at(tree: MerkleTree, indices: Sequence[int]) -> list:
    return open_batch([(tree, indices)])[0]


def verify_openings_batch(requests, hasher=None) -> bool:
    """Verify many single-matrix openings in two native-engine calls: leaf
    hashes grouped by row width, then one sweep over every authentication
    path (``_verify_openings_native`` of the reference), with the Poseidon2
    or the Keccak sweeps as ``hasher`` says.

    ``requests``: [(root_int, (height, width), BatchOpening)].  Returns True
    iff every opening verifies."""
    from ..hash import native_engine as ne

    h = make_hasher(hasher if hasher is not None else p2.DEFAULT_PARAMS)
    if isinstance(h, KeccakHasher):
        leaf_hash, path_roots = ne.kc_hash_columns, ne.kc_merkle_roots
    else:
        def leaf_hash(cols):
            return ne.hash_columns(cols, h.params)

        def path_roots(*args):
            return ne.merkle_roots(*args, h.params)
    if not requests:
        return True
    q = len(requests)
    by_w = {}
    for i, (root, (ht, w), op) in enumerate(requests):
        if len(op.rows) != 1 or len(op.rows[0]) != w:
            return False
        if len(op.siblings) != ht.bit_length() - 1:
            return False
        by_w.setdefault(w, []).append(i)
    dig = np.zeros((q, 4), np.uint64)
    for w, idxs in by_w.items():
        cols = np.stack(
            [
                ne.ints_to_u64([requests[i][2].rows[0][c] for i in idxs])
                for c in range(w)
            ]
        )
        dig[idxs] = leaf_hash(cols)
    max_l = max(len(r[2].siblings) for r in requests)
    sibs = np.zeros((q, max_l, 4), np.uint64)
    mask = np.zeros((q, 4), np.uint64)
    lens = np.zeros(q, np.uint32)
    for k, (_root, _hw, op) in enumerate(requests):
        path_len = len(op.siblings)
        lens[k] = path_len
        if path_len:
            sibs[k, :path_len] = ne.ints_to_u64(op.siblings)
        for lvl in range(path_len):
            if (op.index >> lvl) & 1:
                mask[k, lvl // 64] |= np.uint64(1) << np.uint64(lvl % 64)
    got = ne.u64_to_ints(path_roots(dig, sibs, mask, lens))
    return all(g == r for g, (r, _, _) in zip(got, requests))
