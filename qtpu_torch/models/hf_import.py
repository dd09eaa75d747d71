"""Local Hugging Face checkpoint import (port of qtpu/models/hf_import.py).

Maps a local checkpoint directory (safetensors shards or torch .bin files)
of the LlamaForCausalLM family (Llama, Mistral with its sliding window,
Qwen2 with q/k/v biases), MixtralForCausalLM / Qwen2MoeForCausalLM, GPT-2
or OPT onto the port's stacked-layer params: the same keys and [L, ...]
layout that `qtpu_torch.convert.params_to_torch` makes of qtpu's params.

HF linear weights are [out, in]; the port stores [in, out], so every
projection is transposed on import (GPT-2's Conv1D weights are [in, out]
already). Safetensors files are read by the port's own reader
(`safetensors_io`), straight to torch dtypes, so the card needs neither
the `safetensors` package nor `ml_dtypes`. The tensors are moved to the
device in their stored dtype and transposed, stacked and cast there; the
cast rounds to nearest even, as qtpu's does.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from qtpu_torch.models import safetensors_io
from qtpu_torch.models.config import ModelConfig


def _load_state_dict(ckpt_dir: str) -> dict:
    """All tensors of the safetensors shards or torch bins, on the CPU: as
    stored for safetensors, in f32 for bins (qtpu's `.float()`)."""
    d = Path(ckpt_dir)
    if safetensors_io.shard_files(d):
        return safetensors_io.load_dir(d)
    bin_files = sorted(d.glob("pytorch_model*.bin"))
    if bin_files:
        tensors = {}
        for f in bin_files:
            sd = torch.load(str(f), map_location="cpu", weights_only=True)
            for k, v in sd.items():
                tensors[k] = v.float()
        return tensors
    raise FileNotFoundError(f"no safetensors/bin checkpoints in {ckpt_dir}")


def config_from_hf(ckpt_dir: str) -> ModelConfig:
    """A ModelConfig from a local HF config.json.

    model_type "llama"/"mistral"/"qwen2" all map onto the llama arch:
    Mistral is Llama + sliding-window attention, Qwen2 is Llama + q/k/v
    bias (+ optional sliding window, off by default in HF configs).
    "mixtral" and "qwen2_moe" map onto the moe arch."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "llama")
    if mt not in ("llama", "mistral", "qwen2", "mixtral", "qwen2_moe"):
        raise ValueError(
            f"config_from_hf handles llama-family checkpoints, got "
            f"model_type={mt!r} (use load_gpt2_params/load_opt_params "
            "with an explicit ModelConfig for gpt2/opt)"
        )
    # some configs carry an explicit "head_dim": null; `or` covers both
    # absent and null
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    # HF semantics: Mistral applies the window iff sliding_window is not
    # null; Qwen2 additionally gates it behind use_sliding_window.
    sw = hf.get("sliding_window")
    if mt in ("qwen2", "qwen2_moe") and not hf.get("use_sliding_window", False):
        sw = None
    if mt == "llama":
        sw = None
    moe = mt in ("mixtral", "qwen2_moe")
    # Qwen2-MoE: routed experts use moe_intermediate_size; num_experts is
    # the qwen2_moe key, num_local_experts the mixtral key
    inter = (hf.get("moe_intermediate_size", hf["intermediate_size"])
             if mt == "qwen2_moe" else hf["intermediate_size"])
    return ModelConfig(
        arch="moe" if moe else "llama",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=inter,
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=hf.get("rope_theta", 10000.0),
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 2048),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        attention_bias=bool(hf.get("attention_bias", mt in ("qwen2", "qwen2_moe"))),
        sliding_window=int(sw) if sw else 0,
        num_experts=int(hf.get("num_experts", hf.get("num_local_experts", 0))),
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 2)),
        norm_topk_prob=bool(hf.get("norm_topk_prob", mt == "mixtral")),
        shared_expert_intermediate_size=int(hf.get("shared_expert_intermediate_size", 0)),
    )


class _Reader:
    """Names of one state dict -> tensors of `dtype` on `device`."""

    def __init__(self, ckpt_dir, num_layers, dtype, device):
        self.sd = _load_state_dict(ckpt_dir)
        self.L, self.dtype, self.device = num_layers, dtype, torch.device(device)

    def __contains__(self, name):
        return name in self.sd

    def one(self, name, transpose=False) -> torch.Tensor:
        t = self.sd[name]
        return self.stacked([t.T if transpose else t])[0]

    def stacked(self, mats) -> torch.Tensor:
        """[len(mats), ...] of equal-shaped CPU tensors (views allowed):
        each moved as stored, then laid out and cast on the device."""
        out = torch.empty((len(mats), *mats[0].shape), dtype=self.dtype, device=self.device)
        for i, m in enumerate(mats):
            out[i].copy_(m.to(self.device))
        return out

    def stack(self, fmt, transpose=False) -> torch.Tensor:
        """[L, ...] of the layers' tensors named fmt.format(i)."""
        return self.stacked([self.sd[fmt.format(i)].T if transpose else self.sd[fmt.format(i)]
                             for i in range(self.L)])

    def stack_T(self, fmt) -> torch.Tensor:
        # linear weights: HF [out, in] -> [in, out], stacked over layers
        return self.stack(fmt, transpose=True)

    def lm_head(self, params, tie: bool) -> dict:
        if tie or "lm_head.weight" not in self.sd:
            return {"w": params["embed"].T.contiguous()}
        return {"w": self.one("lm_head.weight", transpose=True)}


def load_llama_params(ckpt_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                      device="cuda") -> dict:
    """HF LlamaForCausalLM state dict -> the port's stacked params."""
    r = _Reader(ckpt_dir, cfg.num_layers, dtype, device)
    prefix = "model.layers.{}."
    params = {
        "embed": r.one("model.embed_tokens.weight"),
        "layers": {
            "attn_norm": r.stack(prefix + "input_layernorm.weight"),
            "mlp_norm": r.stack(prefix + "post_attention_layernorm.weight"),
            "q_proj": {"w": r.stack_T(prefix + "self_attn.q_proj.weight")},
            "k_proj": {"w": r.stack_T(prefix + "self_attn.k_proj.weight")},
            "v_proj": {"w": r.stack_T(prefix + "self_attn.v_proj.weight")},
            "o_proj": {"w": r.stack_T(prefix + "self_attn.o_proj.weight")},
            "gate_proj": {"w": r.stack_T(prefix + "mlp.gate_proj.weight")},
            "up_proj": {"w": r.stack_T(prefix + "mlp.up_proj.weight")},
            "down_proj": {"w": r.stack_T(prefix + "mlp.down_proj.weight")},
        },
        "final_norm": r.one("model.norm.weight"),
    }
    # Qwen2: learned q/k/v bias (Llama/Mistral checkpoints have none)
    if "model.layers.0.self_attn.q_proj.bias" in r:
        for site in ("q_proj", "k_proj", "v_proj"):
            params["layers"][site]["b"] = r.stack(prefix + f"self_attn.{site}.bias")
    params["lm_head"] = r.lm_head(params, cfg.tie_embeddings)
    return params


def load_moe_params(ckpt_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    """HF MixtralForCausalLM / Qwen2MoeForCausalLM state dict -> the port's
    moe params (router [L, D, E], experts stacked [L, E, ...]).

    Key styles: Mixtral `block_sparse_moe.gate` + `experts.{e}.w1/w3/w2`
    (w1=gate, w3=up, w2=down); Qwen2-MoE `mlp.gate` +
    `mlp.experts.{e}.gate_proj/up_proj/down_proj` plus the always-on
    `mlp.shared_expert.*` and its `mlp.shared_expert_gate`, and q/k/v
    biases."""
    r = _Reader(ckpt_dir, cfg.num_layers, dtype, device)
    L, E = cfg.num_layers, cfg.num_experts
    if "model.layers.0.mlp.gate.weight" in r:
        moe_prefix = "mlp"
        names = {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}
    else:
        moe_prefix = "block_sparse_moe"
        names = {"gate": "w1", "up": "w3", "down": "w2"}

    def stack_experts(which):
        # [L, E, in, out] from per-expert [out, in] weights, one layer at a time
        out = None
        for i in range(L):
            layer = r.stacked([
                r.sd[f"model.layers.{i}.{moe_prefix}.experts.{e}.{names[which]}.weight"].T
                for e in range(E)])
            if out is None:
                out = torch.empty((L, *layer.shape), dtype=dtype, device=r.device)
            out[i] = layer
        return out

    prefix = "model.layers.{}."
    params = {
        "embed": r.one("model.embed_tokens.weight"),
        "layers": {
            "attn_norm": r.stack(prefix + "input_layernorm.weight"),
            "mlp_norm": r.stack(prefix + "post_attention_layernorm.weight"),
            "q_proj": {"w": r.stack_T(prefix + "self_attn.q_proj.weight")},
            "k_proj": {"w": r.stack_T(prefix + "self_attn.k_proj.weight")},
            "v_proj": {"w": r.stack_T(prefix + "self_attn.v_proj.weight")},
            "o_proj": {"w": r.stack_T(prefix + "self_attn.o_proj.weight")},
            "router": {"w": r.stack_T(prefix + f"{moe_prefix}.gate.weight")},
            "exp_gate": {"w": stack_experts("gate")},
            "exp_up": {"w": stack_experts("up")},
            "exp_down": {"w": stack_experts("down")},
        },
        "final_norm": r.one("model.norm.weight"),
    }
    if cfg.attention_bias:
        for site in ("q_proj", "k_proj", "v_proj"):
            params["layers"][site]["b"] = r.stack(prefix + f"self_attn.{site}.bias")
    if cfg.shared_expert_intermediate_size > 0:
        layers = params["layers"]
        layers["sh_gate"] = {"w": r.stack_T(prefix + "mlp.shared_expert.gate_proj.weight")}
        layers["sh_up"] = {"w": r.stack_T(prefix + "mlp.shared_expert.up_proj.weight")}
        layers["sh_down"] = {"w": r.stack_T(prefix + "mlp.shared_expert.down_proj.weight")}
        layers["sh_router"] = {"w": r.stack_T(prefix + "mlp.shared_expert_gate.weight")}
    params["lm_head"] = r.lm_head(params, cfg.tie_embeddings)
    return params


def load_gpt2_params(ckpt_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    """HF GPT2LMHeadModel state dict -> the port's stacked params. GPT-2
    uses Conv1D, whose weights are already [in, out]: no transpose."""
    r = _Reader(ckpt_dir, cfg.num_layers, dtype, device)
    pre = "h.{}." if "h.0.ln_1.weight" in r else "transformer.h.{}."
    top = "" if "wte.weight" in r else "transformer."
    embed = r.one(top + "wte.weight")

    def linear(name):
        return {"w": r.stack(pre + name + ".weight"), "b": r.stack(pre + name + ".bias")}

    return {
        "embed": embed,
        "pos_embed": r.one(top + "wpe.weight"),
        "layers": {
            "ln1_w": r.stack(pre + "ln_1.weight"),
            "ln1_b": r.stack(pre + "ln_1.bias"),
            "ln2_w": r.stack(pre + "ln_2.weight"),
            "ln2_b": r.stack(pre + "ln_2.bias"),
            "c_attn": linear("attn.c_attn"),
            "attn_out": linear("attn.c_proj"),
            "mlp_fc": linear("mlp.c_fc"),
            "mlp_proj": linear("mlp.c_proj"),
        },
        "final_norm_w": r.one(top + "ln_f.weight"),
        "final_norm_b": r.one(top + "ln_f.bias"),
        "lm_head": {"w": embed.T.contiguous()},
    }


def load_opt_params(ckpt_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    """HF OPTForCausalLM state dict -> the port's stacked params (linears
    transposed [out, in] -> [in, out])."""
    r = _Reader(ckpt_dir, cfg.num_layers, dtype, device)
    pre = ("model.decoder.layers.{}."
           if "model.decoder.layers.0.self_attn.q_proj.weight" in r else "decoder.layers.{}.")
    top = "model.decoder." if "model.decoder.embed_tokens.weight" in r else "decoder."
    embed = r.one(top + "embed_tokens.weight")

    def linear(name):
        return {"w": r.stack_T(pre + name + ".weight"), "b": r.stack(pre + name + ".bias")}

    return {
        "embed": embed,
        "pos_embed": r.one(top + "embed_positions.weight"),
        "layers": {
            "ln1_w": r.stack(pre + "self_attn_layer_norm.weight"),
            "ln1_b": r.stack(pre + "self_attn_layer_norm.bias"),
            "ln2_w": r.stack(pre + "final_layer_norm.weight"),
            "ln2_b": r.stack(pre + "final_layer_norm.bias"),
            "q_proj": linear("self_attn.q_proj"),
            "k_proj": linear("self_attn.k_proj"),
            "v_proj": linear("self_attn.v_proj"),
            "out_proj": linear("self_attn.out_proj"),
            "fc1": linear("fc1"),
            "fc2": linear("fc2"),
        },
        "final_norm_w": r.one(top + "final_layer_norm.weight"),
        "final_norm_b": r.one(top + "final_layer_norm.bias"),
        "lm_head": {"w": embed.T.contiguous()},
    }


LOADERS = {"llama": load_llama_params, "moe": load_moe_params, "gpt2": load_gpt2_params,
           "opt": load_opt_params}


def load_checkpoint(ckpt_dir: str, cfg: ModelConfig | None = None, dtype=torch.bfloat16,
                    device="cuda"):
    """(params, tokenizer) from a local checkpoint directory. The tokenizer
    is loaded with transformers if tokenizer files are present, else None."""
    if cfg is None:
        cfg = config_from_hf(ckpt_dir)
    params = LOADERS[cfg.arch](ckpt_dir, cfg, dtype, device)
    tokenizer = None
    if (os.path.exists(os.path.join(ckpt_dir, "tokenizer_config.json"))
            or os.path.exists(os.path.join(ckpt_dir, "tokenizer.model"))):
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(ckpt_dir, use_fast=False)
    return params, tokenizer
