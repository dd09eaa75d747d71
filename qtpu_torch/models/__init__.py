from qtpu_torch.models.config import (  # noqa: F401
    TINY_TEST,
    TINYLLAMA_1_1B,
    ModelConfig,
    get_model_config,
)


def get_arch(name: str):
    """Architecture module for a ModelConfig.arch value (llama and moe so
    far; gpt2 and opt come with the model-families slice)."""
    if name == "llama":
        from qtpu_torch.models import llama

        return llama
    if name == "moe":
        from qtpu_torch.models import moe

        return moe
    raise NotImplementedError(f"arch '{name}' is not ported yet (model-families slice)")
