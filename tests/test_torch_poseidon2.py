"""Port Poseidon2 (K4 plain versions on the CPU) vs the JAX reference.

``permute``, ``permute2``, the rate-2 sponge ``hash_columns`` for 1-8
columns (odd tails included) and ``compress`` are held to the reference's
device functions and its ``*_ints`` host oracle, exactly.
"""

import random

import jax.numpy as jnp
import numpy as np
import torch

from linea_stark_tpu.field import fr as ref_fr
from linea_stark_tpu.field.constants import R_MOD
from linea_stark_tpu.hash import poseidon2 as ref_p2
from linea_stark_tpu_torch.field import fr
from linea_stark_tpu_torch.hash import poseidon2 as p2
from linea_stark_tpu_torch.merkle.mmcs import build_levels
from linea_stark_tpu_torch.hash.hasher import Poseidon2Hasher

torch.set_num_threads(1)
rng = random.Random(0x9052)
N = 8
EDGE = [0, 1, R_MOD - 1]


def cols(k):
    return [EDGE + [rng.randrange(R_MOD) for _ in range(N - 3)] for _ in range(k)]


def ref_dev(vals):
    return jnp.asarray(ref_fr.pack_ints(vals))


def test_permute_matches_reference_and_oracle():
    s = cols(3)
    got = [fr.unpack_ints(o) for o in p2.permute(*[fr.pack_ints(c) for c in s])]
    want = [ref_fr.unpack_ints(np.asarray(o)) for o in ref_p2.permute(*[ref_dev(c) for c in s])]
    assert got == want
    for i in range(N):
        assert [g[i] for g in got] == ref_p2.permute_ints([c[i] for c in s])


def test_permute2_is_permute_with_zero_capacity():
    s = cols(2)
    got = [fr.unpack_ints(o) for o in p2.permute2(fr.pack_ints(s[0]), fr.pack_ints(s[1]))]
    for i in range(N):
        assert [g[i] for g in got] == ref_p2.permute_ints([s[0][i], s[1][i], 0])


def test_hash_columns_1_to_8_match_reference():
    c8 = cols(8)
    for w in range(1, 9):
        got = fr.unpack_ints(p2.hash_columns([fr.pack_ints(c) for c in c8[:w]]))
        assert got == [ref_p2.hash_ints([c[i] for c in c8[:w]]) for i in range(N)], w
        if w in (1, 4, 7):  # one chunk, even, odd tail: the JAX device sponge
            want = ref_fr.unpack_ints(
                np.asarray(ref_p2.hash_columns([ref_dev(c) for c in c8[:w]])))
            assert got == want, w


def test_hash_matrix_uses_strided_column_views():
    c4 = cols(4)
    mat = fr.pack_ints(sum(c4, [])).reshape(8, 4, N)
    got = fr.unpack_ints(Poseidon2Hasher().hash_matrix(mat))
    assert got == [ref_p2.hash_ints([c[i] for c in c4]) for i in range(N)]


def test_compress_and_merkle_level_match_reference():
    a, b = cols(2)
    got = fr.unpack_ints(p2.compress(fr.pack_ints(a), fr.pack_ints(b)))
    want = ref_fr.unpack_ints(np.asarray(ref_p2.compress(ref_dev(a), ref_dev(b))))
    assert got == want
    d = fr.pack_ints(a)
    lvl = fr.unpack_ints(p2.merkle_level(d))
    assert lvl == [ref_p2.compress_ints(a[2 * j], a[2 * j + 1]) for j in range(N // 2)]
    root = fr.unpack_ints(build_levels(d, Poseidon2Hasher())[-1])[0]
    cur = a
    while len(cur) > 1:
        cur = [ref_p2.compress_ints(cur[2 * j], cur[2 * j + 1]) for j in range(len(cur) // 2)]
    assert root == cur[0]
