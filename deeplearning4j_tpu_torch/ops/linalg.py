"""Linear-algebra ops (counterpart of deeplearning4j_tpu/ops/linalg.py).

Products run as ``torch.matmul`` with fp32 accumulation for bf16 inputs
(the reference's preferred_element_type); decompositions are torch.linalg.
A decomposition is unique only up to signs and order (qr, svd, eig, eigh),
so callers compare reconstructions, not factors. Integer outputs (pivots,
permutations, ranks) are int32, the reference's type.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


@op("matmul", "linalg", aliases=("mmul", "gemm"))
def matmul(a, b, transpose_a=False, transpose_b=False,
           preferred_element_type=None):
    """(Batched) matrix product; bf16 inputs accumulate in fp32 and come
    back bf16 unless a ``preferred_element_type`` names the output type."""
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    out_dt = C.dtype(preferred_element_type)
    if out_dt is None and a.dtype == torch.bfloat16:
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    if out_dt is not None:
        return torch.matmul(a.to(out_dt), b.to(out_dt))
    return torch.matmul(a, b)


@op("tensormmul", "linalg", aliases=("tensordot",))
def tensormmul(a, b, axes_a, axes_b):
    return torch.tensordot(a, b, dims=(list(axes_a), list(axes_b)))


op("einsum", "linalg")(
    lambda subscripts, *operands: torch.einsum(subscripts, *operands))
op("einsum_apply", "linalg")(
    lambda *operands, equation: torch.einsum(equation, *operands))
op("mmul_vector", "linalg", aliases=("gemv",))(
    lambda a, x: torch.matmul(a, x))


@op("vdot", "linalg")
def vdot(x, y):
    return torch.sum(torch.conj(x.reshape(-1)) * y.reshape(-1))


op("outer", "linalg")(lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)))
op("batched_gemm", "linalg")(
    lambda a, b, transpose_a=False, transpose_b=False: matmul(
        a, b, transpose_a=transpose_a, transpose_b=transpose_b))
op("matrix_diag", "linalg")(lambda x: torch.diag_embed(x))
op("matrix_diag_part", "linalg", aliases=("diag_part",))(
    lambda x: torch.diagonal(x, dim1=-2, dim2=-1))
op("diag", "linalg")(lambda x: torch.diag(x))
op("trace", "linalg")(
    lambda x: torch.diagonal(x, dim1=-2, dim2=-1).sum(-1))
op("matrix_inverse", "linalg")(lambda x: torch.linalg.inv(x))
op("matrix_determinant", "linalg")(lambda x: torch.linalg.det(x))
op("log_matrix_determinant", "linalg")(
    lambda x: torch.linalg.slogdet(x)[1])
op("cholesky", "linalg")(lambda x: torch.linalg.cholesky(x))
op("qr", "linalg")(
    lambda x, full_matrices=False: tuple(torch.linalg.qr(
        x, mode="complete" if full_matrices else "reduced")))


@op("svd", "linalg")
def svd(x, full_matrices=False, compute_uv=True):
    if not compute_uv:
        return torch.linalg.svdvals(x)
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


op("lstsq", "linalg")(
    lambda a, b: torch.linalg.pinv(a) @ b)
op("solve", "linalg", aliases=("linear_solve",))(
    lambda a, b: torch.linalg.solve(a, b))
op("triangular_solve", "linalg")(
    lambda a, b, lower=True: torch.linalg.solve_triangular(
        a, b, upper=not lower, left=True))


def _perm_from_pivots(piv, n):
    """LAPACK row swaps (0-based) -> the permutation vector."""
    perm = torch.arange(n, device=piv.device).expand(
        tuple(piv.shape[:-1]) + (n,)).clone()
    for i in range(piv.shape[-1]):
        j = piv[..., i].long()
        pi = perm[..., i].clone()
        pj = torch.gather(perm, -1, j[..., None])[..., 0]
        perm[..., i] = pj
        perm.scatter_(-1, j[..., None], pi[..., None])
    return perm


@op("lu", "linalg")
def lu(x):
    """(packed LU, int32 0-based pivots, int32 permutation), as
    lax.linalg.lu returns them."""
    lu_mat, piv = torch.linalg.lu_factor(x)
    piv = piv - 1
    return (lu_mat, piv.to(torch.int32),
            _perm_from_pivots(piv, x.shape[-2]).to(torch.int32))


op("eigh", "linalg", aliases=("self_adjoint_eig", "syev"))(
    lambda x: tuple(torch.linalg.eigh(x)))
op("eig", "linalg")(lambda x: tuple(torch.linalg.eig(x)))
op("cross", "linalg")(
    lambda a, b, axis=-1: torch.linalg.cross(a, b, dim=axis))


@op("tri", "linalg", differentiable=False)
def tri(n, m=None, k=0, dtype="float32"):
    m = n if m is None else m
    return torch.tril(torch.ones((int(n), int(m)), dtype=C.dtype(dtype)),
                      diagonal=k)


op("triu", "linalg")(lambda x, k=0: torch.triu(x, k))
op("tril", "linalg")(lambda x, k=0: torch.tril(x, k))
op("kron", "linalg")(lambda a, b: torch.kron(a, b))


@op("vander", "linalg", differentiable=False)
def vander(x, n=None, increasing=False):
    return torch.vander(x, N=n, increasing=increasing)


@op("toeplitz", "linalg", differentiable=False)
def toeplitz(c, r=None):
    """scipy's toeplitz: first column c, first row r (c conjugated when r
    is omitted)."""
    c = c.reshape(-1)
    r = torch.conj(c) if r is None else r.reshape(-1)
    i = torch.arange(c.shape[0], device=c.device)[:, None]
    j = torch.arange(r.shape[0], device=c.device)[None, :]
    vals = torch.cat([r.flip(0)[:-1], c.to(r.dtype)])
    return vals[i - j + r.shape[0] - 1]


op("pinv", "linalg", differentiable=False)(lambda a: torch.linalg.pinv(a))
op("slogdet", "linalg", differentiable=False)(
    lambda a: tuple(torch.linalg.slogdet(a)))
op("matrix_power", "linalg", differentiable=False)(
    lambda a, n: torch.linalg.matrix_power(a, int(n)))
op("matrix_rank", "linalg", differentiable=False)(
    lambda a: torch.linalg.matrix_rank(a).to(torch.int32))
op("expm", "linalg", aliases=("matrix_exp",), differentiable=False)(
    lambda a: torch.linalg.matrix_exp(a))


@op("sqrtm", "linalg", differentiable=False)
def sqrtm(a):
    """Principal square root, complex64 as jax.scipy.linalg.sqrtm returns
    it: V diag(sqrt(w)) V^-1 from the eigendecomposition (a
    diagonalizable input)."""
    w, v = torch.linalg.eig(a.to(torch.complex128))
    out = v @ torch.diag_embed(torch.sqrt(w)) @ torch.linalg.inv(v)
    return out.to(torch.complex64)


op("adjoint", "linalg")(lambda a: torch.conj(a.transpose(-1, -2)))
op("logdet", "linalg", differentiable=False)(
    lambda a: torch.linalg.slogdet(a)[1])
op("cond_number", "linalg", differentiable=False)(
    lambda a, p=None: torch.linalg.cond(a, p=p))


@op("lup", "linalg", differentiable=False)
def lup(a):
    """(L, U, p) with a[p] = L @ U; p int32."""
    lu_mat, piv = torch.linalg.lu_factor(a)
    n = a.shape[-1]
    low = torch.tril(lu_mat, -1) + torch.eye(n, dtype=a.dtype,
                                             device=a.device)
    return low, torch.triu(lu_mat), _perm_from_pivots(
        piv - 1, n).to(torch.int32)


@op("matrix_set_diag", "linalg")
def matrix_set_diag(x, diagonal):
    """Replace the main diagonal of the innermost matrices."""
    m, n = x.shape[-2], x.shape[-1]
    k = min(m, n)
    out = x.clone()
    idx = torch.arange(k, device=x.device)
    out[..., idx, idx] = C.t(diagonal, x).to(x.dtype)
    return out


@op("solve_ls", "linalg", differentiable=False)
def solve_ls(a, b, l2_regularizer=0.0, fast=True):
    """argmin_x |ax - b|^2 + l2 |x|^2: the normal equations when ``fast``,
    the minimum-norm least squares otherwise."""
    if fast:
        at = a.transpose(-1, -2)
        g = at @ a + l2_regularizer * torch.eye(a.shape[-1], dtype=a.dtype,
                                                device=a.device)
        return torch.linalg.solve(g, at @ b)
    return torch.linalg.pinv(a) @ b


@op("sufficient_statistics", "summarystats", differentiable=False)
def sufficient_statistics(x, axes, shift=None):
    """(count, mean_ss, variance_ss, shift)."""
    axes = tuple(axes)
    n = 1
    for ax in axes:
        n *= x.shape[ax]
    count = torch.tensor(float(n), dtype=torch.float32, device=x.device)
    v = x - shift if shift is not None else x
    return count, v.sum(dim=axes), (v * v).sum(dim=axes), shift
