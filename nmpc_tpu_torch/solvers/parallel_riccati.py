"""Parallel-in-time Riccati / LQR solver by an associative scan.

Port of ``nmpc_tpu/solvers/parallel_riccati.py``.  The Riccati recursion
is a linear chain (``DDPSolver.hpp:367``, ``FmpcSolver.hpp:551``) of
O(N) sequential depth.  The backward value recursion is also a
composition of *Riccati flows*, which are closed under composition and
associative, so a parallel scan evaluates every suffix value function in
O(log N) depth (Särkkä & García-Fernández, "Temporal parallelization of
Bayesian smoothers"; arXiv:1809.06360, arXiv:1407.6898).

Formulation:
  * The affine-quadratic problem is homogenized on the extended state
    z = [x; 1]:  z' = Az z + Bz u, cost 1/2 z'Qz z + u'Mz z + 1/2 u'R u.
  * Cross terms are removed by completing the square
    (u = u_hat - R^{-1} Mz z), leaving the cross-free flow
        phi(S) = J + F' S (I + C S)^{-1} F,
    with per-stage F = Az - Bz R^{-1} Mz, C = Bz R^{-1} Bz',
    J = Qz - Mz' R^{-1} Mz.
  * Riccati flows compose:  (phi_a o phi_b)(S) = phi_ab(S) with
        E    = (I + C_a J_b)^{-1}
        F_ab = F_b E F_a
        C_ab = C_b + F_b E C_a F_b'
        J_ab = J_a + F_a' J_b E F_a
    which is associative: the element of the scan.
  * Suffix compositions give S_i for every stage at once; the gains are
    then recovered stagewise and un-shifted back through the square
    completion: u = K x + k.

torch has no associative scan: :func:`associative_scan` is written here
with the odd/even recursion of ``jax.lax.associative_scan`` (combine
adjacent pairs, recurse on the pair totals, fix up the even elements), so
the port forms the same combine tree and matches the JAX package's
parallel result to rounding.  Every level is a handful of batched torch
ops over all its elements; there is no kernel of its own (the JAX
module has no Pallas kernel either).

As in the JAX package, this targets exact LQR/LQT subproblems and
long-horizon MPC where lambda ~ 0: DDP's regularization of the gain solve
alone (``DDPSolver.hpp:438-441``) is a split a composed flow cannot
represent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nmpc_tpu_torch.kernels.ddp_backward import _mm, _mT
from nmpc_tpu_torch.kernels.linalg import _inv_bl


class LQRStage(NamedTuple):
    """Affine-quadratic stage data (all leading axis N).

    Dynamics x' = A x + B u + c; cost
    1/2 x'Qxx x + q'x + 1/2 u'Quu u + r'u + u'Qux x.
    """

    A: torch.Tensor     # [N, nx, nx]
    B: torch.Tensor     # [N, nx, nu]
    c: torch.Tensor     # [N, nx]
    Qxx: torch.Tensor   # [N, nx, nx]
    Quu: torch.Tensor   # [N, nu, nu]
    Qux: torch.Tensor   # [N, nu, nx]
    q: torch.Tensor     # [N, nx]
    r: torch.Tensor     # [N, nu]


def _sym(X):
    return 0.5 * (X + X.transpose(-1, -2))


def _extend(stage: LQRStage):
    """Homogenize on z = [x; 1] and complete the square.

    Returns the flow elements (F, C, J) [N, nz, nz] and (Az, Bz, Mz) for
    the gain recovery."""
    N, nx, nu = stage.B.shape
    nz = nx + 1
    kw = dict(dtype=stage.A.dtype, device=stage.A.device)

    Az = torch.zeros((N, nz, nz), **kw)
    Az[:, :nx, :nx] = stage.A
    Az[:, :nx, nx] = stage.c
    Az[:, nx, nx] = 1.0

    Bz = torch.zeros((N, nz, nu), **kw)
    Bz[:, :nx, :] = stage.B

    Qz = torch.zeros((N, nz, nz), **kw)
    Qz[:, :nx, :nx] = stage.Qxx
    Qz[:, :nx, nx] = stage.q
    Qz[:, nx, :nx] = stage.q

    Mz = torch.zeros((N, nu, nz), **kw)
    Mz[:, :, :nx] = stage.Qux
    Mz[:, :, nx] = stage.r

    Rinv_M = torch.linalg.solve(stage.Quu, Mz)              # [N, nu, nz]
    F = Az - torch.einsum("nij,njk->nik", Bz, Rinv_M)
    Rinv_Bt = torch.linalg.solve(stage.Quu, Bz.transpose(1, 2))
    C = torch.einsum("nij,nkj->nik", Bz, Rinv_Bt.transpose(1, 2))
    J = _sym(Qz - torch.einsum("nji,njk->nik", Mz, Rinv_M))
    return (F, C, J), (Az, Bz, Mz)


def _combine(a, b):
    """(phi_a o phi_b): ``a`` earlier in time, ``b`` later; dense
    matrices with any leading axes."""
    Fa, Ca, Ja = a
    Fb, Cb, Jb = b
    eye = torch.eye(Fa.shape[-1], dtype=Fa.dtype, device=Fa.device)
    E = torch.linalg.inv(eye + Ca @ Jb)
    F_ab = Fb @ E @ Fa
    C_ab = Cb + Fb @ E @ Ca @ Fb.transpose(-1, -2)
    J_ab = Ja + Fa.transpose(-1, -2) @ Jb @ E @ Fa
    return F_ab, _sym(C_ab), _sym(J_ab)


def _combine_bl(a, b):
    """Batch-minor combine: the algebra of :func:`_combine` with every
    contraction unrolled over the trailing element axis (``_mm``, and the
    Gauss-Jordan ``_inv_bl``), as the JAX package's ``_combine_bl``."""
    Fa, Ca, Ja = (torch.movedim(x, 0, -1) for x in a)   # [E,n,n] -> [n,n,E]
    Fb, Cb, Jb = (torch.movedim(x, 0, -1) for x in b)
    nz = Fa.shape[0]
    eye = torch.eye(nz, dtype=Fa.dtype, device=Fa.device)[:, :, None]
    E = _inv_bl(eye + _mm(Ca, Jb))
    FbE = _mm(Fb, E)
    F_ab = _mm(FbE, Fa)
    C_ab = Cb + _mm(_mm(FbE, Ca), _mT(Fb))
    J_ab = Ja + _mm(_mm(_mT(Fa), _mm(Jb, E)), Fa)
    C_ab = 0.5 * (C_ab + _mT(C_ab))
    J_ab = 0.5 * (J_ab + _mT(J_ab))
    return tuple(torch.movedim(x, -1, 0) for x in (F_ab, C_ab, J_ab))


def _interleave(even, odd):
    """Elements 0, 2, 4, ... from ``even`` and 1, 3, ... from ``odd``
    along the leading axis (``len(even)`` is ``len(odd)`` or one more)."""
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of ``fn`` over the leading axis of each tensor of the
    tuple ``elems``, with ``jax.lax.associative_scan``'s recursion and so
    its combine tree; ``fn(a, b)`` takes the earlier and the later partial
    result in scan order (with ``reverse``, the later one in time first).
    """
    elems = tuple(torch.flip(e, (0,)) if reverse else e for e in elems)

    def scan(el):
        n = el[0].shape[0]
        if n < 2:
            return el
        reduced = fn(tuple(e[0:n - 1:2] for e in el),
                     tuple(e[1::2] for e in el))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in el))
        else:
            even = fn(odd, tuple(e[2::2] for e in el))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(el, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan(elems)
    return tuple(torch.flip(o, (0,)) if reverse else o for o in out)


def _terminal(S_T, v_T, like):
    """The extended terminal value matrix [[S_T, v_T], [v_T', 0]] (v_T
    None: zero) at ``like``'s dtype and device."""
    nx = S_T.shape[-1]
    Sz_T = like.new_zeros((nx + 1, nx + 1))
    Sz_T[:nx, :nx] = S_T
    if v_T is not None:
        Sz_T[:nx, nx] = v_T
        Sz_T[nx, :nx] = v_T
    return Sz_T


def _gains(Quu, Az, Bz, Mz, S_next, nx):
    """Stagewise gain recovery from S_{i+1}: (Ks, ks)."""
    G = Quu + torch.einsum("nji,njk,nkl->nil", Bz, S_next, Bz)
    H = torch.einsum("nji,njk,nkl->nil", Bz, S_next, Az) + Mz
    Kz = -torch.linalg.solve(G, H)                          # [N, nu, nz]
    return Kz[:, :, :nx], Kz[:, :, nx]


def solve_lqr_parallel(stage: LQRStage, S_T, v_T=None):
    """All-stage value matrices and gains in O(log N) depth.

    S_T [nx, nx], v_T [nx] parametrize the terminal cost
    1/2 x'S_T x + v_T'x.  Returns (Ks [N, nu, nx], ks [N, nu],
    Ss [N+1, nz, nz] extended-state value matrices).
    """
    nx = stage.A.shape[-1]
    (F, C, J), (Az, Bz, Mz) = _extend(stage)

    # terminal element: the constant flow S -> Sz_T
    Sz_T = _terminal(S_T, v_T, stage.A)
    zero = stage.A.new_zeros((1, nx + 1, nx + 1))
    F_all = torch.cat([F, zero])
    C_all = torch.cat([C, zero])
    J_all = torch.cat([J, Sz_T[None]])

    # suffix compositions: element i composed with everything after it.
    # The reverse scan passes (later-combined, earlier): flip the
    # arguments (nmpc_tpu/solvers/parallel_riccati.py:202-204).
    _, _, Ss = associative_scan(lambda a, b: _combine_bl(b, a),
                                (F_all, C_all, J_all), reverse=True)
    # phi_{i..T}(0) = J: the terminal element has F = 0, so the trailing
    # composition closes the chain whatever the seed.
    Ks, ks = _gains(stage.Quu, Az, Bz, Mz, Ss[1:], nx)
    return Ks, ks, Ss


def solve_lqr_sequential(stage: LQRStage, S_T, v_T=None):
    """The classic backward recursion (``DDPSolver.hpp:367``), the O(N)
    baseline the parallel versions are held against: a Python loop over
    the N stages, a few small torch ops each."""
    N, nx, nu = stage.B.shape
    if v_T is None:
        v_T = stage.A.new_zeros((nx,))
    S, v = S_T, v_T
    Ks, ks = [None] * N, [None] * N
    for i in reversed(range(N)):
        A, B, c = stage.A[i], stage.B[i], stage.c[i]
        Gu = stage.r[i] + B.T @ (S @ c + v)
        G = stage.Quu[i] + B.T @ S @ B
        H = stage.Qux[i] + B.T @ S @ A
        K = -torch.linalg.solve(G, H)
        k = -torch.linalg.solve(G, Gu)
        S_new = stage.Qxx[i] + A.T @ S @ A + H.T @ K
        v = stage.q[i] + A.T @ (S @ c + v) + H.T @ k
        S = 0.5 * (S_new + S_new.T)
        Ks[i], ks[i] = K, k
    return torch.stack(Ks), torch.stack(ks)
