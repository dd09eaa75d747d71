"""Model configurations (own copy of qtpu/models/config.py, so the port
imports nothing of qtpu)."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a causal decoder.

    arch:
      "llama" — RMSNorm, RoPE, GQA, SwiGLU (covers TinyLlama/Llama-2/3,
                and — via attention_bias / sliding_window — Qwen2 and
                Mistral, which are Llama-family variants)
      "gpt2"  — LayerNorm+bias, learned positions, fused QKV, GELU MLP
      "moe"   — llama attention + Mixtral-style sparse-MoE MLP (router +
                num_experts SwiGLU experts, top-k token routing)
    """

    arch: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int = 64
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    tie_embeddings: bool = False
    # Qwen2: learned bias on the q/k/v projections only
    attention_bias: bool = False
    # Mistral (and Qwen2 with use_sliding_window): each query attends to at
    # most this many trailing positions. 0 = full causal.
    sliding_window: int = 0
    # arch="moe" (Mixtral): expert count, tokens' top-k expert fan-out, and
    # whether the top-k routing probabilities are renormalized to sum to 1
    # (True for Mixtral, False for Qwen2-MoE-style routers)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    norm_topk_prob: bool = True
    # Qwen2-MoE: an always-on shared expert (SwiGLU with this intermediate
    # size) whose output is added to the routed-expert mix through a
    # sigmoid gate. 0 = no shared expert (Mixtral).
    shared_expert_intermediate_size: int = 0

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# TinyLlama/TinyLlama_v1.1 (the reference's benchmark model, config.json:2)
TINYLLAMA_1_1B = ModelConfig(
    arch="llama",
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=22,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    rope_theta=10000.0,
    norm_eps=1e-5,
    max_seq_len=2048,
)

LLAMA2_7B = ModelConfig(
    arch="llama",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=11008,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    rope_theta=10000.0,
    norm_eps=1e-5,
    max_seq_len=4096,
)

LLAMA2_70B = ModelConfig(
    arch="llama",
    vocab_size=32000,
    hidden_size=8192,
    intermediate_size=28672,
    num_layers=80,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10000.0,
    norm_eps=1e-5,
    max_seq_len=4096,
)

MISTRAL_7B = ModelConfig(
    arch="llama",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10000.0,
    norm_eps=1e-5,
    max_seq_len=4096,
    sliding_window=4096,
)

QWEN2_7B = ModelConfig(
    arch="llama",
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    rope_theta=1e6,
    norm_eps=1e-6,
    max_seq_len=4096,
    attention_bias=True,
)

QWEN2_0_5B = ModelConfig(
    arch="llama",
    vocab_size=151936,
    hidden_size=896,
    intermediate_size=4864,
    num_layers=24,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    rope_theta=1e6,
    norm_eps=1e-6,
    max_seq_len=4096,
    tie_embeddings=True,
    attention_bias=True,
)

MIXTRAL_8X7B = ModelConfig(
    arch="moe",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1e6,
    norm_eps=1e-5,
    max_seq_len=4096,
    num_experts=8,
    num_experts_per_tok=2,
)

# Qwen2-57B-A14B (Qwen2-MoE): 64 experts top-8, norm_topk_prob=False,
# always-on shared expert with its own sigmoid gate, q/k/v bias
QWEN2_MOE_A14B = ModelConfig(
    arch="moe",
    vocab_size=151936,
    hidden_size=3584,
    intermediate_size=2560,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    rope_theta=1e6,
    norm_eps=1e-6,
    max_seq_len=4096,
    attention_bias=True,
    num_experts=64,
    num_experts_per_tok=8,
    norm_topk_prob=False,
    shared_expert_intermediate_size=20480,
)

TINY_QWEN2_MOE_TEST = ModelConfig(
    arch="moe",
    vocab_size=512,
    hidden_size=256,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    max_seq_len=512,
    attention_bias=True,
    num_experts=4,
    num_experts_per_tok=2,
    norm_topk_prob=False,
    shared_expert_intermediate_size=256,
)

OPT_125M = ModelConfig(
    arch="opt",
    vocab_size=50272,
    hidden_size=768,
    intermediate_size=3072,
    num_layers=12,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    norm_eps=1e-5,
    max_seq_len=2048,
    tie_embeddings=True,
)

GPT2_SMALL = ModelConfig(
    arch="gpt2",
    vocab_size=50257,
    hidden_size=768,
    intermediate_size=3072,
    num_layers=12,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    norm_eps=1e-5,
    max_seq_len=1024,
    tie_embeddings=True,
)

TINY_OPT_TEST = ModelConfig(
    arch="opt",
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=2,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    max_seq_len=512,
    tie_embeddings=True,
)

TINY_GPT2_TEST = ModelConfig(
    arch="gpt2",
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=2,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    max_seq_len=512,
    tie_embeddings=True,
)

TINY_QWEN2_TEST = ModelConfig(
    arch="llama",
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    rope_theta=1e6,
    max_seq_len=512,
    attention_bias=True,
)

TINY_MISTRAL_TEST = ModelConfig(
    arch="llama",
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    max_seq_len=512,
    sliding_window=8,
)

TINY_MOE_TEST = ModelConfig(
    arch="moe",
    vocab_size=512,
    hidden_size=256,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    max_seq_len=512,
    num_experts=4,
    num_experts_per_tok=2,
)

# Tiny test configs (CPU-fast, dims kept multiples of 128 for group tests)
TINY_TEST = ModelConfig(
    arch="llama",
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    max_seq_len=512,
)

PRESET_MODELS = {
    "tinyllama": TINYLLAMA_1_1B,
    "TinyLlama/TinyLlama_v1.1": TINYLLAMA_1_1B,
    "tinyllama-random": TINYLLAMA_1_1B,
    "llama2-7b": LLAMA2_7B,
    "llama2-70b": LLAMA2_70B,
    "mistral-7b": MISTRAL_7B,
    "mistralai/Mistral-7B-v0.1": MISTRAL_7B,
    "qwen2-7b": QWEN2_7B,
    "Qwen/Qwen2-7B": QWEN2_7B,
    "qwen2-0.5b": QWEN2_0_5B,
    "Qwen/Qwen2-0.5B": QWEN2_0_5B,
    "tiny-qwen2-test": TINY_QWEN2_TEST,
    "tiny-mistral-test": TINY_MISTRAL_TEST,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "mistralai/Mixtral-8x7B-v0.1": MIXTRAL_8X7B,
    "tiny-moe-test": TINY_MOE_TEST,
    "qwen2-moe-a14b": QWEN2_MOE_A14B,
    "Qwen/Qwen2-57B-A14B": QWEN2_MOE_A14B,
    "tiny-qwen2-moe-test": TINY_QWEN2_MOE_TEST,
    "gpt2": GPT2_SMALL,
    "gpt2-random": GPT2_SMALL,
    "opt-125m": OPT_125M,
    "facebook/opt-125m": OPT_125M,
    "tiny-test": TINY_TEST,
    "tiny-gpt2-test": TINY_GPT2_TEST,
    "tiny-opt-test": TINY_OPT_TEST,
}


def get_model_config(name: str) -> ModelConfig:
    if name in PRESET_MODELS:
        return PRESET_MODELS[name]
    raise KeyError(
        f"unknown model '{name}'; presets: {sorted(PRESET_MODELS)}"
    )
