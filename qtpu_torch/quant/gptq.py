"""GPTQ, Hessian-informed quantization (port of qtpu/quant/gptq.py).

Two modes, as in qtpu:

1. error_compensation=False, reference parity: per-column symmetric
   scalar-scale quantization (the reference skips the compensation update,
   so the column order and the Hessian do not matter).
2. error_compensation=True, the real algorithm: damped Hessian, the upper
   Cholesky factor U of H⁻¹, per-group asymmetric scales frozen at group
   entry, the sequential per-column quantization with the update
   W[:, j+1:] -= err · U[j, j+1:] / U[j, j], in column blocks with one
   rank-B matmul for the trailing columns.

Every function takes leading batch axes (layers) where qtpu vmaps it:
`gptq_prepare_factor`, `gptq_prepare_factor_lowrank` and
`gptq_column_sweep` advance a chunk of layers in lockstep, one Python loop
over the columns for the whole chunk. torch.linalg's Cholesky and
triangular solve stand in for jnp.linalg (another LAPACK order of sums,
so the compensated sweep agrees with qtpu to a tolerance, not bit for
bit; parity mode is bit for bit). XLA folds the divisions by the constant
2^b - 1 into multiplies by the f32 reciprocal; the port does the same.

Weights are in reference orientation [out_features, in_features];
Hessians are [in, in]. The packed-export support matrix is qtpu's,
enforced by `check_packed_export`.
"""

from __future__ import annotations

import torch


def check_packed_export(w_bit: int, q_group_size: int, blocksize: int, actorder: bool,
                        actorder_shards: int, K: int, error_compensation: bool = True) -> int:
    """Validate a GPTQ packed-export config against the support matrix.
    Returns the effective compensation blocksize; raises ValueError naming
    the violated rule."""
    if w_bit not in (4, 8):
        raise ValueError(f"gptq packed export supports w_bit in (4, 8), got {w_bit}")
    if q_group_size <= 0:
        raise ValueError("gptq packed export requires q_group_size > 0")
    if K % q_group_size:
        raise ValueError(f"q_group_size {q_group_size} does not divide K={K}")
    if not error_compensation:
        raise ValueError(
            "packed export requires error_compensation=True (parity mode "
            "produces no integer codes)"
        )
    if actorder_shards < 1:
        raise ValueError("actorder_shards must be >= 1")
    if actorder and actorder_shards > 1 and K % actorder_shards:
        raise ValueError(
            f"actorder_shards={actorder_shards} does not divide K={K} — a "
            "global perm would cross tensor-parallel shard boundaries at "
            "serve time; pick a shard count dividing every site's K"
        )
    # compensation blocks align up to the scale group so each exported
    # group's scale freezes at group entry
    return max(int(blocksize), q_group_size)


def _eye(C: int, device) -> torch.Tensor:
    return torch.eye(C, dtype=torch.float32, device=device)


def build_proxy_hessian(stat_vectors: torch.Tensor, perp_damp: float = 0.01) -> torch.Tensor:
    """Reference-parity Hessian from stacked mean-abs stat vectors [..., S, C]:
    H = (Σ_s v̂_s v̂_sᵀ) / S + damp·I with v̂ = v / (‖v‖ + 1e−5)."""
    v = stat_vectors.float()
    vn = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-5)
    H = vn.transpose(-1, -2) @ vn
    return H / v.shape[-2] + perp_damp * _eye(v.shape[-1], v.device)


def _parity_column_quantize(W: torch.Tensor, n_bit: int) -> torch.Tensor:
    """Per-column symmetric scalar-scale quantization of [..., out, in] in
    f32, what the reference's skip-compensation loop computes."""
    Wf = W.float()
    max_int = 2**n_bit - 1
    scale = torch.clamp(Wf.abs().amax(dim=-2, keepdim=True) * (1.0 / max_int), min=1e-5)
    q = torch.clamp(torch.round(Wf / scale), -max_int - 1, max_int)
    return q * scale


def _group_params(Wblk: torch.Tensor, n_bit: int):
    """Asymmetric per-row scales and zeros over a column block [..., out, B]."""
    max_int = 2**n_bit - 1
    mx = Wblk.amax(dim=-1, keepdim=True)
    mn = Wblk.amin(dim=-1, keepdim=True)
    scales = torch.clamp(mx - mn, min=1e-5) * (1.0 / max_int)
    zeros = torch.clamp(-torch.round(mn / scales), 0, max_int)
    return scales, zeros


def _rev_chol_upper(A: torch.Tensor) -> torch.Tensor:
    """P upper with P Pᵀ = A, from the Cholesky of the index-flipped matrix;
    NaN where a factorization fails, as jnp.linalg.cholesky gives (torch
    reports the failure in `info` and leaves the factor partial)."""
    Lr, info = torch.linalg.cholesky_ex(A.flip(-1, -2))
    return torch.where((info != 0)[..., None, None], torch.nan, Lr.flip(-1, -2))


def gptq_prepare_factor(H: torch.Tensor, perp_damp: float = 0.01) -> torch.Tensor:
    """Damped Hessian [..., C, C] -> the upper Cholesky factor U of H⁻¹
    (Hinv = UᵀU), without forming H⁻¹: H = PPᵀ (P upper) and U = P⁻¹ by one
    triangular solve. A factorization that fails retries with damping
    mean(diag) + 1 (a PSD H always factors then); a NaN left in U becomes
    the identity's entry, qtpu's last resort."""
    C = H.shape[-1]
    H = H.float()
    eye = _eye(C, H.device)
    mean_diag = torch.diagonal(H, dim1=-2, dim2=-1).mean(dim=-1)[..., None, None]
    P = _rev_chol_upper(H + (perp_damp * mean_diag + 1e-8) * eye)
    bad = torch.isnan(P).flatten(-2).any(dim=-1)
    if bool(bad.any()):
        P = torch.where(bad[..., None, None], _rev_chol_upper(H + (mean_diag + 1.0) * eye), P)
    U = torch.linalg.solve_triangular(P, eye.expand_as(P), upper=True)
    return torch.where(torch.isnan(U), eye, U)


def gptq_prepare_factor_lowrank(stat_vectors: torch.Tensor,
                                perp_damp: float = 0.01) -> torch.Tensor:
    """U for the proxy Hessian built from stat vectors [..., S, C], equal to
    gptq_prepare_factor(build_proxy_hessian(v)) but without forming H or a
    C x C factorization: H = GᵀG + λI with G = v̂/√S, so by Woodbury H⁻¹ is
    diagonal plus rank S and its LDLᵀ has the product form L[i, j] =
    G[:, i]ᵀ b_j, a sweep over the C columns carrying an S x S matrix
    (O(C·S²)) and one [C, S] x [S, C] product."""
    v = stat_vectors.float()
    S, C = v.shape[-2:]
    norms = torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-5
    G = v / (norms * torch.sqrt(torch.tensor(float(S), dtype=torch.float32, device=v.device)))
    # the damping prepare(build_proxy_hessian(v)) applies:
    # λ = damp (build) + damp · mean_diag(H₀) (prepare) + 1e-8
    mean_diag = (G * G).sum(dim=(-2, -1)) / C + perp_damp
    lam = (perp_damp + perp_damp * mean_diag + 1e-8)[..., None, None]
    alpha = 1.0 / lam[..., 0]  # [..., 1]
    Sigma = -torch.linalg.inv(lam * _eye(S, v.device) + G @ G.transpose(-1, -2)) / lam
    Bs, ds = [], []
    for j in range(C):
        w = G[..., :, j]  # [..., S]
        c = (Sigma @ w[..., None])[..., 0]
        d = alpha + (w * c).sum(dim=-1, keepdim=True)
        b = c / d
        Sigma = Sigma - c[..., :, None] * b[..., None, :]
        Bs.append(b)
        ds.append(d)
    B = torch.stack(Bs, dim=-2)  # [..., C, S]
    d = torch.clamp(torch.cat(ds, dim=-1), min=1e-30)  # [..., C]
    M_full = G.transpose(-1, -2) @ B.transpose(-1, -2)  # [..., C, C]
    eye = _eye(C, v.device)
    U = torch.sqrt(d)[..., :, None] * (eye + torch.triu(M_full.transpose(-1, -2), diagonal=1))
    bad = torch.isnan(U).flatten(-2).any(dim=-1)[..., None, None]
    return torch.where(bad, eye, U)


def proxy_hessian_diag(stat_vectors: torch.Tensor, perp_damp: float = 0.01) -> torch.Tensor:
    """diag(build_proxy_hessian(v)) without forming H."""
    v = stat_vectors.float()
    vn = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-5)
    return (vn * vn).sum(dim=-2) / v.shape[-2] + perp_damp


def actorder_perm(d: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """Columns in descending Hessian-diagonal order (stable, int32 as
    jnp.argsort gives), within each of `shards` contiguous blocks."""
    K = d.shape[-1]
    blk = K // shards
    parts = [torch.argsort(-d[..., i * blk:(i + 1) * blk], dim=-1, stable=True) + i * blk
             for i in range(shards)]
    return torch.cat(parts, dim=-1).to(torch.int32)


def gptq_quantize_layer(W, H, n_bit: int, q_group_size: int = 128, perp_damp: float = 0.01,
                        blocksize: int = 128, actorder: bool = False,
                        error_compensation: bool = True, return_ints: bool = False,
                        stat_vectors=None):
    """GPTQ-quantize one [out, in] weight with Hessian H [in, in], or with
    the proxy's stat vectors [S, C] (H may be None; S < C takes the
    low-rank prepare). return_ints (compensation on, actorder off) also
    returns the codes [out, in] in [0, 2^b), scales and zeros [out, in/g]."""
    orig_dtype = W.dtype
    Wf = W.float()
    C = Wf.shape[-1]
    if not error_compensation:
        # per-column quantization is order independent: the actorder
        # permutation cancels exactly
        if return_ints:
            raise NotImplementedError("return_ints needs error_compensation")
        return _parity_column_quantize(Wf, n_bit).to(orig_dtype)
    if return_ints and actorder:
        raise NotImplementedError(
            "packed export with actorder would scatter groups (g_idx); off"
        )
    if stat_vectors is not None and stat_vectors.shape[-2] < C:
        if actorder:
            perm = torch.argsort(-proxy_hessian_diag(stat_vectors, perp_damp), stable=True)
            U = gptq_prepare_factor_lowrank(stat_vectors[..., perm], perp_damp)
            return gptq_column_sweep(Wf[..., perm], U, n_bit, q_group_size, blocksize,
                                     return_ints, orig_dtype, torch.argsort(perm))
        U = gptq_prepare_factor_lowrank(stat_vectors, perp_damp)
        return gptq_column_sweep(Wf, U, n_bit, q_group_size, blocksize, return_ints, orig_dtype)
    if H is None:
        H = build_proxy_hessian(stat_vectors, perp_damp)
    inv_perm = None
    if actorder:
        # columns in Hessian-diagonal order; the factor of the permuted H
        perm = torch.argsort(-torch.diagonal(H.float()), stable=True)
        inv_perm = torch.argsort(perm)
        Wf = Wf[..., perm]
        H = H[perm][:, perm]
    U = gptq_prepare_factor(H, perp_damp)
    return gptq_column_sweep(Wf, U, n_bit, q_group_size, blocksize, return_ints, orig_dtype,
                             inv_perm)


def gptq_column_sweep(Wf, U, n_bit: int, q_group_size: int, blocksize: int,
                      return_ints: bool = False, orig_dtype=torch.float32, inv_perm=None):
    """The sequential error-compensated sweep given the factor U: Wf
    [..., out, C] f32, U [..., C, C]; the leading axes advance in lockstep.
    Returns the dequantized weight in orig_dtype, and with return_ints also
    (codes, scales [..., out, C/g], zeros) in f32."""
    C = Wf.shape[-1]
    g = q_group_size if q_group_size > 0 else C
    B = min(blocksize, g)  # compensation blocks align to scale groups
    if C % B != 0:
        B = g if C % g == 0 else C
    if return_ints and B != g:
        raise NotImplementedError(
            f"packed export needs block == group ({B} != {g}); set blocksize >= q_group_size"
        )
    max_int = 2**n_bit - 1
    W = Wf.float().clone()  # quantized in place, column by column
    Q = torch.empty_like(W) if return_ints else None
    s_cols, z_cols = [], []
    for lo in range(0, C, B):
        hi = lo + B
        Wb = W[..., lo:hi]
        # scales frozen at group entry from the current (compensated) block
        scales, zeros = _group_params(Wb, n_bit)
        Ub = U[..., lo:hi, lo:hi]
        Err = torch.empty_like(Wb)
        for j in range(B):
            wj = Wb[..., j:j + 1]
            qj = torch.clamp(torch.round(wj / scales) + zeros, 0, max_int)
            dqj = (qj - zeros) * scales
            err = (wj - dqj) / Ub[..., j:j + 1, j:j + 1]
            if j + 1 < B:
                Wb[..., j + 1:] -= err * Ub[..., j:j + 1, j + 1:]
            wj.copy_(dqj)
            Err[..., j:j + 1] = err
            if Q is not None:
                Q[..., lo + j:lo + j + 1] = qj
        s_cols.append(scales)
        z_cols.append(zeros)
        if hi < C:
            # rank-B update of all trailing columns, one matmul
            W[..., hi:] -= Err @ U[..., lo:hi, hi:]
    Wq = W if inv_perm is None else W[..., inv_perm]
    if not return_ints:
        return Wq.to(orig_dtype)
    return Wq.to(orig_dtype), Q, torch.cat(s_cols, dim=-1), torch.cat(z_cols, dim=-1)
