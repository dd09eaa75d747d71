from qtpu_torch.models.config import (  # noqa: F401
    TINY_TEST,
    TINYLLAMA_1_1B,
    ModelConfig,
    get_model_config,
)


def get_arch(name: str):
    """Architecture module for a ModelConfig.arch value: llama, moe, gpt2
    or opt."""
    import importlib

    if name not in ("llama", "moe", "gpt2", "opt"):
        raise KeyError(f"unknown arch '{name}'")
    return importlib.import_module(f"qtpu_torch.models.{name}")
