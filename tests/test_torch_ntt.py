"""Port NTT / coset LDE vs the JAX reference on the CPU, exactly.

Same (W, n) inputs from a seeded RNG go through ``linea_stark_tpu.ntt`` and
``linea_stark_tpu_torch.ntt``; both are natural order in and out.  The port
runs the K3 stage kernel's plain version here (odd log2(n) exercises the
leading radix-2 stage, even log2(n) pure radix 4).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linea_stark_tpu.field import fr as ref_fr
from linea_stark_tpu.field.constants import COSET_SHIFT, R_MOD
from linea_stark_tpu.ntt import coset_lde as ref_coset_lde
from linea_stark_tpu.ntt import intt as ref_intt
from linea_stark_tpu.ntt import ntt as ref_ntt
from linea_stark_tpu_torch.field import fr
from linea_stark_tpu_torch.kernels import ntt as kn
from linea_stark_tpu_torch.ntt.ntt import _twiddle_table, coset_lde, intt, ntt, root_of_unity

torch.set_num_threads(1)
W = 2


def _inputs(log_n):
    rng = random.Random(1000 + log_n)
    vals = [rng.randrange(R_MOD) for _ in range(W << log_n)]
    planes = ref_fr.pack_ints(vals).reshape(16, W, 1 << log_n)
    return vals, planes, fr.from_ref_planes(planes)


@pytest.mark.parametrize("log_n", range(4, 11))
def test_ntt_intt_coset_lde_match_reference(log_n):
    _, planes, x = _inputs(log_n)
    ref_x = jnp.asarray(planes)
    np.testing.assert_array_equal(fr.to_ref_planes(ntt(x)), np.asarray(ref_ntt(ref_x)))
    np.testing.assert_array_equal(fr.to_ref_planes(intt(x)), np.asarray(ref_intt(ref_x)))
    got = coset_lde(x, 3, COSET_SHIFT)  # blowup 8, as the main path
    want = ref_coset_lde(ref_x, 3, COSET_SHIFT)
    np.testing.assert_array_equal(fr.to_ref_planes(got), np.asarray(want))


def test_ntt_matches_naive_dft():
    vals, _, x = _inputs(5)
    n = 32
    w = root_of_unity(5)
    got = fr.unpack_ints(ntt(x))
    for c in range(W):
        row = vals[c * n:(c + 1) * n]
        want = [sum(row[j] * pow(w, j * k, R_MOD) for j in range(n)) % R_MOD for k in range(n)]
        assert got[c * n:(c + 1) * n] == want


@pytest.mark.parametrize("radix", [2, 4])
def test_stage_plain_is_radix2_composition(radix):
    """One radix-4 stage equals two radix-2 stages (the kernel fuses them)."""
    _, _, x = _inputs(6)
    table = _twiddle_table(6, False, None)
    y = kn.stage(x, table, 4, radix)
    two = kn.stage_plain(kn.stage_plain(x, table, 4, 2), table, 8, 2)
    if radix == 4:
        assert torch.equal(y, two)
    else:
        assert torch.equal(y, kn.stage_plain(x, table, 4, 2))
