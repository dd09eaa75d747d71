"""Benchmark configs and presets (port of qtpu/configs/__init__.py).

The same JSON schema and defaults as qtpu (the reference's config.json plus
qtpu's mesh / serving / output keys), with one key of the port's own:
"device" ("cuda" unless the config or the CLI says "cpu"). `presets.json`
is a copy of qtpu's. Every preset loads and validates here; a mesh larger
than the world runs single-device, as in qtpu (qtpu_torch.bench.runner).

CLI:  python -m qtpu_torch.configs list | <preset-name> [--out PATH]
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

_PRESETS_PATH = Path(__file__).parent / "presets.json"


def load_config(config_path) -> dict:
    """Load a benchmark configuration from a JSON file."""
    with open(config_path) as f:
        return json.load(f)


def save_config(config: dict, config_path) -> None:
    with open(config_path, "w") as f:
        json.dump(config, f, indent=2)


def default_config() -> dict:
    """The full default schema: reference keys first, then qtpu's
    extensions (mesh, serving, output), then the port's device."""
    return {
        "model_name": "tinyllama-random",
        "quantization_methods": ["awq", "gptq", "pot", "apot", "smoothquant"],
        "calibration_dataset": "synthetic",
        "calibration_dataset_config": None,
        "calibration_split": "validation",
        "test_dataset": "synthetic",
        "test_dataset_config": None,
        "test_split": "test",
        "n_calibration_samples": 32,
        "calibration_block_size": 512,
        "n_test_samples": 10,
        "test_block_size": 1024,
        "quantization_config": {
            "awq": {
                "w_bit": 4,
                "q_group_size": 128,
                "protect_ratio": 0.01,
                "scale_factor": 2.0,
                "search_scale": False,
            },
            "gptq": {
                "w_bit": 4,
                "q_group_size": 128,
                "perp_damp": 0.01,
                "blocksize": 128,
                "nsamples": 32,
                "actorder": False,
                "error_compensation": True,
            },
            "pot": {"w_bit": 4, "q_group_size": 128},
            "apot": {"w_bit": 4, "q_group_size": 128, "k": 2},
            "smoothquant": {
                "w_bit": 8,
                "q_group_size": 128,
                "alpha": 0.5,
                "search_alpha": False,
            },
        },
        "dtype": "bfloat16",
        "use_fast_tokenizer": False,
        "verbose": True,
        "mesh": {"data": 1, "model": 1, "pipe": 1},
        "seed": 0,
        "serving": {
            "kv_cache_dtype": "int8",
            "max_batch_size": 8,
            "max_seq_len": 2048,
        },
        "output_path": "benchmark_results.json",
        "device": "cuda",
    }


REQUIRED_KEYS = (
    "model_name",
    "quantization_methods",
    "n_calibration_samples",
    "calibration_block_size",
    "n_test_samples",
    "test_block_size",
    "quantization_config",
)


def validate_config(config: dict) -> dict:
    """Fill defaults for missing keys and check the required structure."""
    merged = default_config()
    _deep_update(merged, config)
    for key in REQUIRED_KEYS:
        if key not in merged:
            raise KeyError(f"config missing required key: {key}")
    for method in merged["quantization_methods"]:
        if method != "raw" and method not in merged["quantization_config"]:
            raise KeyError(f"no quantization_config for method '{method}'")
    return merged


def _deep_update(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def load_presets() -> dict:
    with open(_PRESETS_PATH) as f:
        return json.load(f)


def list_presets() -> list[str]:
    return sorted(load_presets())


def setup_config(preset_name: str, out_path="config.json") -> dict:
    """Write a named preset, validated, to a config file (the 'description'
    key is dropped)."""
    presets = load_presets()
    if preset_name not in presets:
        raise KeyError(f"unknown preset '{preset_name}'; available: {list_presets()}")
    cfg = copy.deepcopy(presets[preset_name])
    cfg.pop("description", None)
    cfg = validate_config(cfg)
    save_config(cfg, out_path)
    return cfg
