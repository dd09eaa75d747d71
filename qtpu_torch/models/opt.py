"""OPT family decoder (port of qtpu/models/opt.py): pre-LN, learned
positions with HF's offset 2, separate q/k/v/out projections with biases
(or one fused "qkv_proj" packed site, quant.apply.fuse_packed_sites), ReLU
MLP. The body, its kernels and its cache contract are GPT-2's
(models/gpt2.py)."""

from __future__ import annotations

import torch

from qtpu_torch.models.config import ModelConfig
from qtpu_torch.models.gpt2 import Family, _base_params, decoder_forward, decoder_forward_with_cache
from qtpu_torch.models.ops import linear
from qtpu_torch.serve.kvcache import KVCache

LAYER_SITES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
# the sites whose input dim K splits under tensor parallelism
# (qtpu/models/opt.py:34)
ROW_PARALLEL_SITES = ("out_proj", "fc2")
INPUT_SITES = ("attn_in", "o_in", "mlp_in", "fc2_in", "head_in")
SITE_OF_INPUT = {
    "attn_in": ("q_proj", "k_proj", "v_proj"),
    "o_in": ("out_proj",),
    "mlp_in": ("fc1",),
    "fc2_in": ("fc2",),
    "head_in": ("lm_head",),
}
# HF OPT's learned positional embedding indexes position + 2
# (modeling_opt.OPTLearnedPositionalEmbedding)
POS_OFFSET = 2


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=torch.bfloat16) -> dict:
    """Random-normal weights (std 0.02) drawn from a torch.Generator on
    `device`, LayerNorms at 1 and 0, zero biases (qtpu's init); the position
    table has max_seq_len + 2 rows."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    sites = {"q_proj": D, "k_proj": D, "v_proj": D, "out_proj": D, "fc1": F, "fc2": (F, D)}
    return _base_params(cfg, sites, cfg.max_seq_len + POS_OFFSET, seed, device, dtype)


def _qkv(h, layers, cfg: ModelConfig, qm, l):
    """Q/K/V projections, or the fused "qkv_proj" site split in three (OPT
    is MHA: each slice is [.., D])."""
    B, T = h.shape[:2]
    H, hd = cfg.num_heads, cfg.head_dim
    if "qkv_proj" in layers:
        q, k, v = torch.split(linear(h, layers["qkv_proj"], qm("qkv_proj"), layer=l), H * hd,
                              dim=-1)
    else:
        q, k, v = (linear(h, layers[s], qm(s), layer=l) for s in ("q_proj", "k_proj", "v_proj"))
    return q.reshape(B, T, H, hd), k.reshape(B, T, H, hd), v.reshape(B, T, H, hd)


OPT = Family(qkv=_qkv, act=torch.relu, o_site="out_proj", fc_site="fc1", proj_site="fc2",
             proj_input="fc2_in", pos_offset=POS_OFFSET)


def forward(params, input_ids, cfg: ModelConfig, qmeta=None, capture: str = "none", tp=None):
    """input_ids [B, S] -> logits [B, S, V] f32 (with capture: (logits,
    stats), the input sites of INPUT_SITES)."""
    return decoder_forward(OPT, params, input_ids, cfg, qmeta, capture, tp)


def forward_with_cache(params, input_ids, positions, cache: KVCache, cfg: ModelConfig,
                       qmeta=None, slots=None, tp=None):
    return decoder_forward_with_cache(OPT, params, input_ids, positions, cache, cfg, qmeta, slots,
                                      tp)
