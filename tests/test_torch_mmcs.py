"""Port MMCS vs the JAX reference: roots at heights 2^3..2^9 equal the
reference's, and the port's openings pass the reference's
``verify_openings_batch`` (and the port's own)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linea_stark_tpu.field import fr as ref_fr
from linea_stark_tpu.field.constants import R_MOD
from linea_stark_tpu.hash import np_poseidon2 as ref_npp
from linea_stark_tpu.merkle import mmcs as ref_mmcs
from linea_stark_tpu.merkle.mmcs import BatchOpening as RefOpening
from linea_stark_tpu_torch.field import fr
from linea_stark_tpu_torch.merkle import mmcs

torch.set_num_threads(1)
W = 3


def _matrix(log_h):
    rng = random.Random(500 + log_h)
    vals = [rng.randrange(R_MOD) for _ in range(W << log_h)]
    planes = ref_fr.pack_ints(vals).reshape(16, W, 1 << log_h)
    return vals, planes, fr.from_ref_planes(planes)


def _host_root(vals, h):
    """The reference's host sponge and tree (its native C engine)."""
    cols = [np.array(vals[c * h:(c + 1) * h], dtype=object) for c in range(W)]
    return int(ref_npp.tree_levels_vec(ref_npp.hash_columns_vec(cols))[-1][0])


@pytest.mark.parametrize("log_h", range(3, 10))
def test_root_and_openings_match_reference(log_h):
    h = 1 << log_h
    vals, planes, mat = _matrix(log_h)
    tree = mmcs.commit([mat])
    root = tree.root_int()
    assert root == _host_root(vals, h)
    if log_h in (3, 6):  # the JAX device commit as well
        assert root == ref_mmcs.commit([jnp.asarray(planes)]).root_int()
    idx = [0, h - 1, h // 2, 5 % h]
    openings = mmcs.open_at(tree, idx)
    for op, i in zip(openings, idx):
        assert op.rows == [[vals[c * h + i] for c in range(W)]]
    reqs = [(root, (h, W), op) for op in openings]
    assert mmcs.verify_openings_batch(reqs)
    ref_reqs = [(root, (h, W), RefOpening(op.index, op.rows, op.siblings)) for op in openings]
    assert ref_mmcs.verify_openings_batch(ref_reqs)


def test_tampered_opening_fails():
    vals, _, mat = _matrix(4)
    tree = mmcs.commit([mat])
    op = mmcs.open_at(tree, [3])[0]
    op.rows[0][1] = (op.rows[0][1] + 1) % R_MOD
    assert not mmcs.verify_openings_batch([(tree.root_int(), (16, W), op)])
    op2 = mmcs.open_at(tree, [3])[0]
    op2.siblings[2] ^= 1
    assert not mmcs.verify_openings_batch([(tree.root_int(), (16, W), op2)])
