"""Shared NN ops: RMSNorm, LayerNorm, tanh-approximate GELU, RoPE,
full-sequence causal attention and the quantization-aware linear (port of
qtpu/models/ops.py).

A linear site's params are {"w": dense [K, N]} or packed {"data", "scales",
"zeros"} (qtpu_torch.core.packing), optionally with a bias "b", an input
"smooth" vector [K] (SmoothQuant / AWQ) and a GPTQ actorder "perm" [K].
Packed sites go to the K1 dequant-matmul, W8A8 sites (5-tuple metas tagged
"a8") to K6, POT/APOT sites (packed with a "codebook" of levels) to K7.
Under tensor parallelism a W8A8 row-parallel site runs K6's absmax pass on
the rank's K slice, an all-reduce MAX over the group, and K6 quantizing with
that per-token absmax (its absmax-in mode: int32 sums), an all-reduce SUM and
K6's rescale: qtpu's GSPMD takes the absmax over the whole K and reduces
before the rescale, and so the ranks' bits are one rank's.
`causal_attention` runs K5 (flash attention) on CUDA tensors of the head
dims it takes.

The attention route, as qtpu's (ops.py:133-157; decode llama.py:318): a
model asks each attention kernel from the shape whether it takes the call
(`flash_attention.supported`, `kv_attention.decode_supported` /
`flash_supported`, beside the kernels' own checks) and otherwise runs that
kernel's plain version -- qtpu's XLA math -- on the same tensors, card or
CPU, through `plain_attention`, which counts those calls. Nothing is
decided by catching a launch's exception.
"""

from __future__ import annotations

import math

import torch

from qtpu_torch.kernels.codebook_matmul import codebook_matmul
from qtpu_torch.kernels.dequant_matmul import quantized_matmul
from qtpu_torch.kernels import flash_attention as _k5
from qtpu_torch.kernels.flash_attention import attention_mask, flash_attention
from qtpu_torch.kernels.int8_matmul import w8a8_absmax, w8a8_epilogue, w8a8_matmul
from qtpu_torch.sharding import collectives as coll


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with bias in f32 (population variance), cast back to x's
    dtype, as qtpu's `layer_norm`."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True): 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables of rotate-half RoPE. positions [..., S] -> [..., S, hd]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exps / head_dim))
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; cos/sin [..., S, hd] broadcast over heads."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return (x.float() * c + rotated.float() * s).to(x.dtype)


def plain_attention(plain, *args, **kw):
    """plain(*args, **kw): an attention kernel's plain version for a call
    whose shape the kernel does not take (the route above), counted in
    `plain_attention.launches`. The kernels take every shape qtpu hands a
    Pallas kernel (hd a multiple of 8 from 8 to 256, any G), so on the card
    this runs only outside that: hd % 8 != 0, or hd > 256 (where the port's
    K2, like qtpu's route into its kernels, stops)."""
    plain_attention.launches += 1
    return plain(*args, **kw)


plain_attention.launches = 0


def causal_attention(q, k, v, window: int = 0):
    """Full-sequence causal attention with GQA: q [B, S, H, hd], k/v [B, S,
    KV, hd] -> [B, S, H * hd]; with window > 0 query i sees keys (i -
    window, i].

    A CUDA tensor at a head dim K5 takes (a multiple of 8 from 8 to 256) runs
    K5 at any S on `transpose(1, 2)` views (no repeat of the KV heads, no
    transpose copy, no mask tensor: the kernel masks by position and
    `window`). A CPU tensor, and a head dim K5 does not take (counted by
    plain_attention), runs qtpu's XLA math
    (ops.py:147-157): KV heads repeated, f32 scores, -1e30 where the mask is
    False, probabilities cast to q's dtype."""
    B, S, H, hd = q.shape
    if H == 0:  # a tensor-parallel rank that holds no head
        return q.new_zeros(B, S, 0)
    if not _k5.supported(hd):
        return plain_attention(_attention_xla, q, k, v, window)
    if q.device.type != "cpu":
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window)
        return out.transpose(1, 2).reshape(B, S, H * hd)
    return _attention_xla(q, k, v, window)


def _attention_xla(q, k, v, window: int):
    """qtpu's XLA attention (ops.py:147-157) on q's device."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    mask = attention_mask(S, window, q.device)[None, None]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(hd)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float()).to(q.dtype)
    return out.reshape(B, S, H * hd)


def is_a8(site_meta) -> bool:
    """A W8A8 site: a 5-tuple meta tagged "a8"."""
    return site_meta is not None and len(site_meta) == 5 and site_meta[4] == "a8"


def _a8_split(x: torch.Tensor, p: dict, site_meta, tp) -> torch.Tensor:
    """A row-parallel W8A8 site's whole product x @ W on every rank of tp,
    the rank holding a K slice of x and W: K6's absmax pass over the slice
    and an all-reduce MAX (the per-token scale spans all of K), K6's int32
    sums on that absmax (its absmax-in mode) and an all-reduce SUM (exact:
    the zero correction is linear in K), then K6's rescale. The bits are one
    rank's whole product's: qtpu's GSPMD reduces before the rescale too. A
    rank without rows joins both all-reduces with zeros."""
    N = p["data"].shape[-1]
    if x.shape[-1]:
        amax = coll.all_reduce(w8a8_absmax(x), tp, op="max")
        total = w8a8_matmul(x, p["data"], p["scales"], p["zeros"], site_meta[:4], absmax=amax)
    else:
        amax = coll.all_reduce(x.new_zeros(*x.shape[:-1], 1, dtype=torch.float32), tp,
                               op="max")
        total = torch.zeros(*x.shape[:-1], N, dtype=torch.int32, device=x.device)
    return w8a8_epilogue(coll.all_reduce(total, tp), amax, p["scales"], x.dtype)


def linear(x: torch.Tensor, p: dict, site_meta=None, layer=None, tp=None) -> torch.Tensor:
    """y = maybe_smooth(x)[..., perm] @ W (+ b), qtpu's `ops.linear`. layer
    selects one layer of stacked [L, ...] params as zero-copy views. tp: the
    group of a row-parallel site's K split: a W8A8 site, whose per-token
    scale spans all of K, then returns its whole product on every rank
    (`_a8_split`); other sites return the rank's partial product.
    Column-parallel sites pass none. A rank that holds none of a site's rows
    or columns (an uneven split) gives zeros, launching nothing."""
    if layer is not None:
        p = {k: v[layer] for k, v in p.items()}
    if "smooth" in p:
        x = x * p["smooth"].to(x.dtype)
    if "perm" in p:
        # actorder GPTQ: weights stored in Hessian-diagonal order, the
        # activations gathered into the same order (g_idx style)
        x = x.index_select(-1, p["perm"])
    N = (p["w"] if "w" in p else p["data"]).shape[-1]
    if is_a8(site_meta) and split_sum(tp):
        y = _a8_split(x, p, site_meta, tp)
    elif x.shape[-1] == 0 or N == 0:
        y = torch.zeros(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    elif "w" in p:
        y = x @ p["w"].to(x.dtype)
    elif "codebook" in p:
        y = codebook_matmul(x, p["data"], p["scales"], p["codebook"], site_meta)
    elif is_a8(site_meta):
        y = w8a8_matmul(x, p["data"], p["scales"], p["zeros"], site_meta[:4])
    else:
        y = quantized_matmul(x, p["data"], p["scales"], p.get("zeros"), site_meta)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def lead(tp) -> bool:
    """Whether this rank adds what a row-parallel sum takes once (the
    bias): rank 0 of the group, or every rank without one."""
    return coll.rank(tp) == 0


def split_sum(tp) -> bool:
    """Whether a row-parallel site's output is a sum of partials over more
    than one rank (a group of one runs the unsharded arithmetic)."""
    return coll.size(tp) > 1


def reduce_add(resid: torch.Tensor, y: torch.Tensor, tp) -> torch.Tensor:
    """resid + the group's sum of the partial outputs y: the partials
    all-reduced in f32 and the residual added once, rounded once to
    resid's dtype (a bf16 sum would round the residual stream twice a
    site)."""
    return (resid.float() + coll.all_reduce(y.float(), tp)).to(resid.dtype)


def row_linear(x: torch.Tensor, resid: torch.Tensor, p: dict, site_meta=None, layer=None,
               tp=None) -> torch.Tensor:
    """resid + linear(x, p) over a row-parallel site. Under tp the rank's
    partial product (the bias on rank 0 only) goes through `reduce_add`
    (qtpu's psum); a group of one adds in line, then all-reduces. A W8A8
    site's whole product comes back from `linear` on every rank (its sums
    reduced before the rescale), and is added as one rank adds it: a
    difference of the rounding here would move the next sites' per-token
    int8 codes (summing bf16 partials put the 22-layer TinyLlama W8A8 at
    TP 2 0.12 from its one-rank logits on an H100)."""
    if not split_sum(tp):
        y = resid + linear(x, p, site_meta, layer=layer)
        return y if tp is None else coll.all_reduce(y, tp)
    if is_a8(site_meta):
        return resid + linear(x, p, site_meta, layer=layer, tp=tp)
    if not lead(tp) and "b" in p:
        p = {k: v for k, v in p.items() if k != "b"}
    return reduce_add(resid, linear(x, p, site_meta, layer=layer), tp)


def _gathered(x: torch.Tensor, gather, tp) -> torch.Tensor:
    """x itself, or with gather = (every rank's width, first, end) every
    rank's x all-gathered along the last dim and [first, end) taken."""
    if not gather:
        return x
    sizes, k0, k1 = gather
    full = coll.all_gather(x.contiguous(), tp, dim=-1, sizes=sizes)
    return full if (k0, k1) == (0, full.shape[-1]) else full[..., k0:k1].contiguous()


def o_input(attn: torch.Tensor, cfg, tp) -> torch.Tensor:
    """The attention's row-parallel site's input on this rank: the
    attention output of its heads, or (`cfg.o_gather` of
    sharding.specs.LocalConfig) every rank's output all-gathered and the
    whole groups its rows hold taken, or all of it for an actorder perm
    that crosses the ranks' rows."""
    return _gathered(attn, getattr(cfg, "o_gather", ()), tp)


def mlp_input(act: torch.Tensor, cfg, tp) -> torch.Tensor:
    """The MLP's row-parallel site's input on this rank: its columns of the
    activation, or, for an actorder perm that crosses the ranks' rows
    (`cfg.mlp_gather`), every rank's columns all-gathered."""
    return _gathered(act, getattr(cfg, "mlp_gather", ()), tp)


def gather_logits(logits: torch.Tensor, tp=None) -> torch.Tensor:
    """The column-parallel lm_head's local [..., V / tp] logits gathered
    into [..., V] in rank order."""
    return logits if tp is None else coll.all_gather(logits, tp, dim=-1)
