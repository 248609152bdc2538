"""Two-adic FRI PCS: commit / open / verify over coset LDEs; port of
``linea_stark_tpu/pcs/two_adic_fri.py`` for the native transcript with
materialized (non-streamed) LDEs.

The heavy phases (LDE, Merkle sweeps, opening reduction, FRI folds) are
whole-domain device computations; the challenger's observe/sample points
are the host syncs.  FRI rounds at/below ``2 * _FRI_HOST_TAIL_NATIVE``
elements fold and commit on the host through the native C engine.

Native mode folds with arity 4 (one β per round; the arity-4 fold is the
two chained arity-2 folds with β, β²) and commits each folded codeword
grouped (arity, N/arity), so one leaf feeds the next round's fold.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .. import fr_ops as fo
from ..field import fr, oracle
from ..field.constants import R_MOD
from ..fri.fold import fold_codeword, fold_pair_int
from ..hash import native_engine as ne
from ..hash.hasher import KeccakHasher
from ..merkle import mmcs
from ..ntt.ntt import _coset_scale, coset_lde, ntt, pad_coeffs, root_of_unity
from ..utils.timing import span


class VerificationError(Exception):
    pass


def _fused() -> bool:
    """The phase mode, read from ``LINEA_FUSED`` at call time (default "1").
    "0" selects the reference's eager phases: the quotient's and the open's
    batch inversions take :func:`..fr_ops.batch_inverse_eager` (finished by
    K6); nothing else changes.  The proof bytes are the same in both
    modes."""
    return os.environ.get("LINEA_FUSED", "1") != "0"


def _chunk_ldes_impl(chunks, log_blowup: int, shift: int, omega_lde: int):
    """(8, B, n) chunk evals on cosets shift·ω^i -> (8, B, n·blowup) on
    shift·H_big; the per-chunk inverse coset scale is built by block
    doubling so the NTTs run with B as a plain batch axis."""
    b, n = chunks.shape[1], chunks.shape[-1]
    dev = chunks.device
    coeffs = ntt(chunks, inverse=True, scale=True)
    inv_shift = pow(shift, R_MOD - 2, R_MOD)
    inv_omega = pow(omega_lde, R_MOD - 2, R_MOD)
    cur = fo.powers(inv_shift, n, dev)[:, None, :]
    size = 1
    while size < b:
        r_k = fo.powers(pow(inv_omega, size, R_MOD), n, dev)
        cur = torch.cat([cur, fo.mul(cur, r_k[:, None, :])], dim=1)
        size *= 2
    coeffs = fo.mul(coeffs, cur[:, :b])
    padded = pad_coeffs(coeffs, log_blowup)
    big_n = n << log_blowup
    padded = fo.mul(padded, _coset_scale(big_n, shift, dev)[:, None, :])
    return ntt(padded)


# FRI folds at/below twice this size run on the host (native C engine).
# The value is the reference's; it changes no proof bytes.
_FRI_HOST_TAIL_NATIVE = 1 << 13


@dataclass
class PcsData:
    """Prover-side state of one commitment round."""

    tree: mmcs.MerkleTree
    lde: torch.Tensor  # (8, W, n_lde) natural-order evals on shift·H_lde


@dataclass
class TwoAdicFriPcs:
    fri: object                 # config.FriConfig
    hasher: object              # hash.hasher.Poseidon2Hasher or KeccakHasher
    shift: int
    transcript: str = "native"
    check_low_degree: bool = True

    def __post_init__(self):
        if self.transcript != "native":
            raise NotImplementedError(f"transcript {self.transcript!r} is not ported")

    # ------------------------------------------------------------------
    # Commit
    # ------------------------------------------------------------------

    def commit_trace(self, trace: torch.Tensor):
        """Evals on H_n -> (root_int, PcsData) committed on shift·H_lde."""
        with span("coset_lde_batch"):
            lde = coset_lde(trace, self.fri.log_blowup, self.shift)
        with span("merkle commit"):
            tree = mmcs.commit([lde], self.hasher)
            root = tree.root_int()
        return root, PcsData(tree, lde)

    def commit_quotient(self, chunks: torch.Tensor):
        """Chunk evals on their own cosets -> (root_int, PcsData): chunk i
        lives on shift·ω_lde^i·H_n; all chunks LDE in one batched transform
        and commit as one width-B matrix."""
        n = chunks.shape[-1]
        log_lde = (n.bit_length() - 1) + self.fri.log_blowup
        omega_lde = root_of_unity(log_lde)
        with span("coset_lde_batch", dims=f"{chunks.shape[1]}x{n}"):
            stack = _chunk_ldes_impl(chunks, self.fri.log_blowup, self.shift, omega_lde)
        with span("merkle commit"):
            tree = mmcs.commit([stack], self.hasher)
            root = tree.root_int()
        return root, PcsData(tree, stack)

    # ------------------------------------------------------------------
    # Opened values (barycentric)
    # ------------------------------------------------------------------

    def _barycentric_open(self, matrix_lde, z, denom_inv, x_vec) -> list:
        """p(z) = (z^N − s^N)/(N·s^N) · sum_j p(x_j)·x_j/(z−x_j) per column."""
        n = matrix_lde.shape[-1]
        s_n = pow(self.shift, n, R_MOD)
        const = oracle.mul(
            oracle.sub(pow(z, n, R_MOD), s_n), oracle.inv((n * s_n) % R_MOD)
        )
        u = fo.mul(x_vec, denom_inv)
        vals = fo.weighted_sums_to_ints(matrix_lde, u)
        return [oracle.mul(v, const) for v in vals]

    def _open_values(self, trace_lde, chunk_stack, zeta: int, zeta_next: int, x_vec):
        """Inverse denominators + barycentric opened values.  Returns
        (di, trace_at_zeta, trace_at_zeta_next, chunks_at_zeta) where
        di = (8, 2, n_lde) inverses of (ζ−x, ζ·g−x)."""
        with span("compute_inverse_denominators"):
            dev = x_vec.device
            inverse = fo.batch_inverse if _fused() else fo.batch_inverse_eager
            di = inverse(torch.stack([
                fo.sub(fr.const(zeta, device=dev), x_vec),
                fo.sub(fr.const(zeta_next, device=dev), x_vec),
            ], dim=1))
        with span("opened values (barycentric)"):
            trace_at_zeta = self._barycentric_open(trace_lde, zeta, di[:, 0], x_vec)
            trace_at_zeta_next = self._barycentric_open(
                trace_lde, zeta_next, di[:, 1], x_vec
            )
            chunks_at_zeta = self._barycentric_open(chunk_stack, zeta, di[:, 0], x_vec)
        return di, trace_at_zeta, trace_at_zeta_next, chunks_at_zeta

    def _reduce_codeword(self, trace_lde, chunk_stack, di, alpha_p: int, opened):
        """FRI input f0 = sum_g dinv_g·(sum_c α'^k·col_c − sum_c α'^k·y_c),
        k running over [trace@ζ cols, trace@ζ·g cols, chunks@ζ] from α'^0."""
        ys_all = [v for group in opened for v in group]
        kpows = [pow(alpha_p, k, R_MOD) for k in range(len(ys_all))]
        f0 = None
        k = 0
        for mat, d_idx in ((trace_lde, 0), (trace_lde, 1), (chunk_stack, 0)):
            num = None
            gconst = 0
            for c in range(mat.shape[1]):
                t = fo.mul_const(mat[:, c], kpows[k])
                gconst = oracle.add(gconst, oracle.mul(kpows[k], ys_all[k]))
                k += 1
                num = t if num is None else fo.add(num, t)
            num = fo.sub(num, fr.const(gconst, device=num.device))
            term = fo.mul(num, di[:, d_idx])
            f0 = term if f0 is None else fo.add(f0, term)
        return f0

    # ------------------------------------------------------------------
    # Open (opened values + FRI proof); owns the challenger during opening
    # ------------------------------------------------------------------

    def open(self, trace_data: PcsData, quot_data: PcsData, zeta: int,
             zeta_next: int, challenger):
        """Returns (trace_at_zeta, trace_at_zeta_next, chunks_at_zeta,
        FriProof): opened values observed, then α' sampled."""
        trace_lde, chunk_stack = trace_data.lde, quot_data.lde
        n_lde = trace_lde.shape[-1]
        omega_lde = root_of_unity(n_lde.bit_length() - 1)

        with span("open"):
            x_vec = fo.mul_const(fo.powers(omega_lde, n_lde, trace_lde.device), self.shift)
            di, trace_at_zeta, trace_at_zeta_next, chunks_at_zeta = self._open_values(
                trace_lde, chunk_stack, zeta, zeta_next, x_vec
            )
            for v in trace_at_zeta + trace_at_zeta_next + chunks_at_zeta:
                challenger.observe(v)
            alpha_p = challenger.sample()
            with span("reduce matrix quotient"):
                f0 = self._reduce_codeword(
                    trace_lde, chunk_stack, di, alpha_p,
                    (trace_at_zeta, trace_at_zeta_next, chunks_at_zeta),
                )
            del di, x_vec

        with span("FRI prover"):
            fri_proof = self._fri_prove_native(
                f0, trace_data.tree, quot_data.tree, challenger
            )
        return trace_at_zeta, trace_at_zeta_next, chunks_at_zeta, fri_proof

    # ------------------------------------------------------------------
    # FRI ladder
    # ------------------------------------------------------------------

    def _commit_grouped(self, f, arity: int):
        """Commit a folded codeword as the (arity, N/arity) matrix whose leaf
        j is [f(j), f(j + N/a), ...] — a free reshape of natural order."""
        size = f.shape[-1]
        return mmcs.commit([f.reshape(8, arity, size // arity)], self.hasher)

    def _round_plan(self, n_lde: int):
        """Deterministic native-mode fold schedule: [(size, arity,
        committed)] per round + final codeword size.  Arity 4 while a
        quarter still reaches the final size, one arity-2 round to land on
        it when needed; the last fold's result is sent as final_poly."""
        final = 1 << (self.fri.log_blowup + self.fri.log_final_poly_len)
        plan = []
        size = n_lde
        while size > final:
            arity = 4 if size // 4 >= final else 2
            new = size // arity
            plan.append((size, arity, new > final))
            size = new
        return plan, final

    def _fri_prove_native(self, f0, trace_tree, quotient_tree, challenger):
        from ..prover.proof import FriProof, QueryProof

        fri_cfg = self.fri
        n_lde = f0.shape[-1]
        log_lde = n_lde.bit_length() - 1
        plan, final_size = self._round_plan(n_lde)
        f = f0
        f_host = None  # _HostTail state once the tail goes host-side
        cur_shift, cur_omega, size = self.shift, root_of_unity(log_lde), n_lde
        fold_trees, fold_roots = [], []
        tail = _HostTail(self.hasher)

        with span("commit phase (fold+commit per round)"):
            for size_r, arity, will_commit in plan:
                assert size == size_r
                beta = challenger.sample()
                beta2 = oracle.mul(beta, beta)
                if f_host is None and size <= 2 * _FRI_HOST_TAIL_NATIVE:
                    f_host = tail.from_device(f)
                new_size = size // arity
                next_arity = 4 if new_size // 4 >= final_size else 2
                shift2 = (cur_shift * cur_shift) % R_MOD
                omega2 = (cur_omega * cur_omega) % R_MOD
                if f_host is None:
                    f = fold_codeword(f, beta, cur_shift, cur_omega)
                    if arity == 4:
                        f = fold_codeword(f, beta2, shift2, omega2)
                else:
                    f_host = tail.fold(f_host, beta, cur_shift, cur_omega)
                    if arity == 4:
                        f_host = tail.fold(f_host, beta2, shift2, omega2)
                cur_shift = pow(cur_shift, arity, R_MOD)
                cur_omega = pow(cur_omega, arity, R_MOD)
                size = new_size
                if will_commit:
                    if f_host is None:
                        t = self._commit_grouped(f, next_arity)
                        root = t.root_int()
                    else:
                        t, root = tail.commit_grouped(f_host, next_arity)
                    fold_trees.append(t)
                    fold_roots.append(root)
                    challenger.observe(root)

        if f_host is None:
            f_host = tail.from_device(f)
        final_poly = self._final_poly(tail.to_ints(f_host), cur_shift)
        for c in final_poly:
            challenger.observe(c)

        pow_witness = self._grind(challenger)

        with span("query phase"):
            a0 = plan[0][1] if plan else 2
            seg0 = n_lde // a0
            indices = [
                challenger.sample_bits(log_lde - (a0.bit_length() - 1))
                for _ in range(fri_cfg.num_queries)
            ]
            spread = [i + k * seg0 for k in range(a0) for i in indices]
            requests = [(trace_tree, spread), (quotient_tree, spread)]
            for t in fold_trees:
                lc = t.matrices[0].shape[-1]  # leaf count of the grouped matrix
                requests.append((t, [idx % lc for idx in indices]))
            opened = mmcs.open_batch(requests)
            nq = fri_cfg.num_queries
            query_proofs = [
                QueryProof(
                    input_openings=[
                        [opened[0][k * nq + qi] for k in range(a0)],
                        [opened[1][k * nq + qi] for k in range(a0)],
                    ],
                    commit_openings=[
                        opened[2 + r][qi] for r in range(len(fold_trees))
                    ],
                )
                for qi in range(nq)
            ]

        return FriProof(
            commit_roots=fold_roots,
            final_poly=final_poly,
            pow_witness=pow_witness,
            query_proofs=query_proofs,
        )

    def _final_poly(self, evals: list, shift_int: int) -> list:
        """Coefficients of the final codeword's polynomial on shift·H (naive
        inverse DFT — the codeword is tiny); asserts the low-degree tail."""
        coeffs = _interpolate_host(evals, shift_int)
        n_final = 1 << self.fri.log_final_poly_len
        if self.check_low_degree:
            assert all(v == 0 for v in coeffs[n_final:]), "final codeword not low degree"
        return coeffs[:n_final]

    def _grind(self, challenger) -> int:
        with span("grind PoW"):
            bits = self.fri.proof_of_work_bits
            if bits > 0:
                raise NotImplementedError("the proof-of-work grind is not ported")
            challenger.observe(0)
            assert challenger.sample_bits(0) == 0
            return 0

    # ------------------------------------------------------------------
    # Verify (host-side)
    # ------------------------------------------------------------------

    def verify(self, trace_root: int, quotient_root: int, dims, opened_values,
               zeta: int, zeta_next: int, fri_proof, challenger) -> None:
        """Replays the PCS slice of the transcript and checks every Merkle
        opening and FRI fold walk.  ``dims`` = ((n_lde, w), (n_lde,
        n_chunks)); ``opened_values`` = (trace_at_zeta, trace_at_zeta_next,
        chunks_at_zeta).  Raises VerificationError."""
        fri_cfg = self.fri
        (n_lde, w), (_, n_chunks) = dims
        log_lde = n_lde.bit_length() - 1
        omega_lde = root_of_unity(log_lde)
        trace_at_zeta, trace_at_zeta_next, chunks_at_zeta = opened_values

        for v in trace_at_zeta + trace_at_zeta_next + chunks_at_zeta:
            challenger.observe(v)
        alpha_p = challenger.sample()

        plan, _final_size = self._round_plan(n_lde)
        n_committed = sum(1 for p in plan if p[2])
        if len(fri_proof.commit_roots) != n_committed:
            raise VerificationError("wrong number of FRI commitments")
        betas = []
        ci = 0
        for _size_r, _arity, committed in plan:
            betas.append(challenger.sample())
            if committed:
                challenger.observe(fri_proof.commit_roots[ci])
                ci += 1
        if len(fri_proof.final_poly) != 1 << fri_cfg.log_final_poly_len:
            raise VerificationError("bad final poly length")
        for c in fri_proof.final_poly:
            challenger.observe(c)
        if not challenger.check_witness(fri_cfg.proof_of_work_bits, fri_proof.pow_witness):
            raise VerificationError("proof-of-work check failed")
        a0 = plan[0][1] if plan else 2
        seg0 = n_lde // a0
        indices = [
            challenger.sample_bits(log_lde - (a0.bit_length() - 1))
            for _ in range(fri_cfg.num_queries)
        ]
        if len(fri_proof.query_proofs) != len(indices):
            raise VerificationError("wrong number of query proofs")
        # round r >= 1 reads committed tree r-1: grouping = round r's arity
        groupings = [plan[r][1] for r in range(1, len(plan))]

        merkle_requests = []
        for qi, idx in enumerate(indices):
            qp = fri_proof.query_proofs[qi]
            if len(qp.input_openings) != 2 or any(
                len(group) != a0 for group in qp.input_openings
            ):
                raise VerificationError("malformed input openings")
            t_ops, q_ops = qp.input_openings
            for k in range(a0):
                want = idx + k * seg0
                if t_ops[k].index != want or q_ops[k].index != want:
                    raise VerificationError("opening index mismatch")
                merkle_requests.append((trace_root, (n_lde, w), t_ops[k]))
                merkle_requests.append((quotient_root, (n_lde, n_chunks), q_ops[k]))
            if len(qp.commit_openings) != n_committed:
                raise VerificationError("malformed fold openings")
            size_q = n_lde // a0
            for r, g in enumerate(groupings):
                lc = size_q // g
                merkle_requests.append(
                    (fri_proof.commit_roots[r], (lc, g), qp.commit_openings[r])
                )
                size_q //= g
        if not mmcs.verify_openings_batch(merkle_requests, self.hasher):
            raise VerificationError("Merkle opening failed")

        for qi, idx in enumerate(indices):
            qp = fri_proof.query_proofs[qi]
            t_ops, q_ops = qp.input_openings
            x0 = oracle.mul(self.shift, pow(omega_lde, idx, R_MOD))
            i_fac = pow(omega_lde, seg0, R_MOD)
            vals = []
            x_k = x0
            for k in range(a0):
                vals.append(
                    _reduced_at(
                        x_k, t_ops[k].rows[0], q_ops[k].rows[0], zeta,
                        zeta_next, trace_at_zeta, trace_at_zeta_next,
                        chunks_at_zeta, alpha_p,
                    )
                )
                x_k = oracle.mul(x_k, i_fac)
            v = _fold_arity_int(vals, x0, i_fac, betas[0])
            pos = idx
            cur_shift = pow(self.shift, a0, R_MOD)
            cur_omega = pow(omega_lde, a0, R_MOD)
            size = n_lde // a0
            for r, g in enumerate(groupings):
                lc = size // g
                p = pos % lc
                op = qp.commit_openings[r]
                if op.index != p:
                    raise VerificationError("fold opening index mismatch")
                row = op.rows[0]
                if row[pos // lc] != v:
                    raise VerificationError(
                        f"fold consistency failed (query {qi}, round {r + 1})"
                    )
                x_p = oracle.mul(cur_shift, pow(cur_omega, p, R_MOD))
                v = _fold_arity_int(row, x_p, pow(cur_omega, lc, R_MOD), betas[r + 1])
                pos = p
                cur_shift = pow(cur_shift, g, R_MOD)
                cur_omega = pow(cur_omega, g, R_MOD)
                size = lc

            x_fin = oracle.mul(cur_shift, pow(cur_omega, pos, R_MOD))
            acc = 0
            for c in reversed(fri_proof.final_poly):
                acc = oracle.add(oracle.mul(acc, x_fin), c)
            if v != acc:
                raise VerificationError("final polynomial check failed")


def _fold_arity_int(vals: list, x0: int, i_fac: int, beta: int) -> int:
    """Scalar arity-2/4 fold of [f(x0·i_fac^k)] with challenge β (arity 4 =
    the two chained arity-2 folds with β, β²)."""
    if len(vals) == 2:
        return fold_pair_int(vals[0], vals[1], x0, beta)
    assert len(vals) == 4
    g_lo = fold_pair_int(vals[0], vals[2], x0, beta)
    g_hi = fold_pair_int(vals[1], vals[3], oracle.mul(x0, i_fac), beta)
    return fold_pair_int(g_lo, g_hi, oracle.mul(x0, x0), oracle.mul(beta, beta))


def _reduced_at(x, trace_row, quot_row, zeta, zeta_next, trace_at_zeta,
                trace_at_zeta_next, chunks_at_zeta, alpha_p) -> int:
    """Reduced-codeword value at point x from opened rows (the verifier-side
    mirror of the prover's reduce-matrix-quotient)."""
    acc = 0
    k = 1
    for rows, z, ys in (
        (trace_row, zeta, trace_at_zeta),
        (trace_row, zeta_next, trace_at_zeta_next),
        (quot_row, zeta, chunks_at_zeta),
    ):
        num = 0
        for c, rv in enumerate(rows):
            num = oracle.add(num, oracle.mul(k, oracle.sub(rv, ys[c])))
            k = oracle.mul(k, alpha_p)
        acc = oracle.add(acc, oracle.mul(num, oracle.inv(oracle.sub(z, x))))
    return acc


# ---------------------------------------------------------------------------
# Host tail: fold + commit small FRI levels on the CPU (native C engine)
# ---------------------------------------------------------------------------

class _HostTail:
    """Codeword state for the host-side FRI tail: ``(n, 4)`` uint64 canonical
    rows of the native engine."""

    def __init__(self, hasher):
        self.hasher = hasher

    def from_device(self, f: torch.Tensor):
        return ne.from_mont(fr.to_u64_rows(f))

    def to_ints(self, state) -> list:
        return ne.u64_to_ints(state)

    def fold(self, state, beta: int, shift_int: int, omega_int: int):
        return ne.fold(state, beta, shift_int, omega_int)

    def commit_grouped(self, state, arity: int):
        """Commit the arity-grouping of the codeword; returns (tree, root).
        Leaf j hashes [f(j), f(j+n/a), ...] (the next round's fold inputs).
        The tree's matrix and levels stay on the host (CPU tensors)."""
        n = len(state)
        half = n // arity  # leaf count
        cols = state.reshape(arity, half, 4)
        if isinstance(self.hasher, KeccakHasher):
            d = ne.kc_hash_columns(cols)
            ups = [d] + (ne.kc_tree_levels(d) if half > 1 else [])
        else:
            params = self.hasher.params
            d = ne.hash_columns(cols, params)
            ups = [d] + (ne.tree_levels(d, params) if half > 1 else [])
        levels = [fr.from_u64_rows(ne.to_mont(lv)) for lv in ups]
        grouped = fr.from_u64_rows(ne.to_mont(state)).reshape(8, arity, half)
        root = ne.u64_to_ints(ups[-1][-1:])[0]
        tree = mmcs.MerkleTree([grouped], levels, self.hasher, root_cache=root)
        return tree, root


def _interpolate_host(evals: list, shift_int: int) -> list:
    """Coefficients of the polynomial with these evals on shift·H (naive
    O(m²) inverse DFT — m is the tiny final codeword)."""
    m = len(evals)
    w_inv = oracle.inv(root_of_unity(m.bit_length() - 1))
    m_inv = oracle.inv(m)
    s_inv = oracle.inv(shift_int % R_MOD)
    coeffs = []
    for d in range(m):
        acc = 0
        for j in range(m):
            acc = oracle.add(acc, oracle.mul(evals[j], pow(w_inv, j * d, R_MOD)))
        coeffs.append(oracle.mul(oracle.mul(acc, m_inv), pow(s_inv, d, R_MOD)))
    return coeffs
