"""The port's local Hugging Face import (qtpu_torch.models.hf_import and its
own safetensors reader) against qtpu's and against transformers.

Tiny random HF models (2 layers, hidden 128) of the seven families
(llama, mistral, qwen2, mixtral, qwen2_moe, gpt2, opt) are saved with
save_pretrained, as safetensors and as torch .bin, into tmp_path. For each:
config_from_hf equals qtpu's field by field; every tensor the port loads
equals qtpu's bit for bit, loaded in f32 and in bf16; and the port's
forward logits agree with the HF model's and with qtpu's forward on qtpu's
load (rtol/atol 2e-2, as tests/test_hf_parity.py: f32 weights, the sums
taken in another order). The reader equals the safetensors package bit for
bit on every dtype it takes, on one file and on a sharded checkpoint.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from qtpu.models import get_arch as jax_get_arch
from qtpu.models import hf_import as jhf
from qtpu.models.config import ModelConfig as JaxModelConfig
from qtpu_torch.convert import to_numpy, to_torch
from qtpu_torch.models import get_arch
from qtpu_torch.models import hf_import as thf
from qtpu_torch.models import safetensors_io
from qtpu_torch.models.config import ModelConfig
from test_torch_quant import one_torch_thread  # noqa: F401  (a fixture)

LOGIT_TOL = 2e-2
V, D, L = 256, 128, 2


def _hf_model(family):
    """A random tiny HF model of `family`, eval mode, biases perturbed so
    that a dropped bias shows; and for gpt2/opt the explicit ModelConfig
    fields (config_from_hf refuses those families, as qtpu's does)."""
    t = transformers
    common = dict(vocab_size=V, hidden_size=D, num_hidden_layers=L, num_attention_heads=4,
                  max_position_embeddings=128)
    explicit = None
    if family == "llama":
        cfg = t.LlamaConfig(intermediate_size=256, num_key_value_heads=2, rms_norm_eps=1e-5,
                            tie_word_embeddings=False, **common)
        cls = t.LlamaForCausalLM
    elif family == "mistral":
        cfg = t.MistralConfig(intermediate_size=256, num_key_value_heads=2, sliding_window=8,
                              **common)
        cls = t.MistralForCausalLM
    elif family == "qwen2":
        cfg = t.Qwen2Config(intermediate_size=256, num_key_value_heads=2, rope_theta=1e6,
                            tie_word_embeddings=False, **common)
        cls = t.Qwen2ForCausalLM
    elif family == "mixtral":
        cfg = t.MixtralConfig(intermediate_size=96, num_key_value_heads=2, num_local_experts=4,
                              num_experts_per_tok=2, **common)
        cls = t.MixtralForCausalLM
    elif family == "qwen2_moe":
        cfg = t.Qwen2MoeConfig(intermediate_size=96, moe_intermediate_size=64,
                               shared_expert_intermediate_size=96, num_key_value_heads=2,
                               num_experts=4, num_experts_per_tok=2, norm_topk_prob=False,
                               decoder_sparse_step=1, mlp_only_layers=[], **common)
        cls = t.Qwen2MoeForCausalLM
    elif family == "gpt2":
        cfg = t.GPT2Config(vocab_size=V, n_positions=128, n_embd=D, n_layer=L, n_head=4)
        cls = t.GPT2LMHeadModel
        explicit = dict(arch="gpt2", intermediate_size=4 * D, tie_embeddings=True)
    else:
        cfg = t.OPTConfig(ffn_dim=256, do_layer_norm_before=True, word_embed_proj_dim=D,
                          **common)
        cls = t.OPTForCausalLM
        explicit = dict(arch="opt", intermediate_size=256, tie_embeddings=True)
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = cls(cfg).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias") and "proj" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    if explicit is not None:
        explicit = dict(vocab_size=V, hidden_size=D, num_layers=L, num_heads=4, num_kv_heads=4,
                        head_dim=D // 4, max_seq_len=128, **explicit)
    return model, explicit


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{(family, format): (checkpoint dir, HF model, explicit config)}."""
    out = {}
    for family in ("llama", "mistral", "qwen2", "mixtral", "qwen2_moe", "gpt2", "opt"):
        model, explicit = _hf_model(family)
        for fmt in ("safetensors", "bin"):
            d = tmp_path_factory.mktemp(f"{family}_{fmt}")
            model.save_pretrained(d, safe_serialization=fmt == "safetensors")
            out[family, fmt] = (str(d), model, explicit)
    return out


FAMILIES = ["llama", "mistral", "qwen2", "mixtral", "qwen2_moe", "gpt2", "opt"]


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("family", FAMILIES)
def test_import_equals_qtpu_and_hf(saved, family, fmt):
    d, model, explicit = saved[family, fmt]
    assert any(p.suffix == (".safetensors" if fmt == "safetensors" else ".bin")
               for p in Path(d).iterdir())
    if explicit is None:
        ct, cj = thf.config_from_hf(d), jhf.config_from_hf(d)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    else:
        with pytest.raises(ValueError, match="llama-family"):
            thf.config_from_hf(d)
        ct, cj = ModelConfig(**explicit), JaxModelConfig(**explicit)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        pt, tok = thf.load_checkpoint(d, ct, tdt, device="cpu")
        pj, _ = jhf.load_checkpoint(d, cj, jdt)
        assert tok is None
        lt, lj = _leaves(pt), _leaves(pj)
        assert sorted(lt) == sorted(lj)
        for k in lt:
            a, b = to_numpy(lt[k]), np.asarray(lj[k])
            assert lt[k].dtype == tdt and a.shape == b.shape and a.dtype == b.dtype, k
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{k} ({tdt})")
    # f32 weights: the port's forward against the HF model and qtpu's forward
    pt, _ = thf.load_checkpoint(d, ct, torch.float32, device="cpu")
    pj, _ = jhf.load_checkpoint(d, cj, jnp.float32)
    ids = np.random.default_rng(0).integers(0, V, (1, 20))
    with torch.no_grad():
        hf = model(torch.tensor(ids)).logits.float().numpy()
        got = get_arch(ct.arch).forward(pt, torch.from_numpy(ids), ct).float().numpy()
    want = np.asarray(jax_get_arch(cj.arch).forward(pj, jnp.asarray(ids), cj))
    np.testing.assert_allclose(got, hf, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


# tiiuae/Falcon3-7B-Base's published config.json: a LlamaForCausalLM with an
# explicit head_dim of 256
FALCON3_7B_HF = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 11, "eos_token_id": 11, "head_dim": 256, "hidden_act": "silu",
    "hidden_size": 3072, "initializer_range": 0.02, "intermediate_size": 23040,
    "max_position_embeddings": 32768, "mlp_bias": False, "model_type": "llama",
    "num_attention_heads": 12, "num_hidden_layers": 28, "num_key_value_heads": 4,
    "pretraining_tp": 1, "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000042,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 131072}


def test_falcon3_7b_config_equals_qtpus_and_the_smokes(tmp_path):
    """Falcon3-7B-Base's config.json gives one config in both packages:
    head_dim 256 (its explicit key, here also hidden / heads), q_dim 3072, G 3;
    chip_smoke.FALCON3_7B (the falcon3 phase's model, cut in depth there)
    equals it field for field, norm_topk_prob aside (MoE-only: config_from_hf
    reads it as False off a llama, ModelConfig's default is True)."""
    import chip_smoke

    (tmp_path / "config.json").write_text(json.dumps(FALCON3_7B_HF))
    ct, cj = thf.config_from_hf(str(tmp_path)), jhf.config_from_hf(str(tmp_path))
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert (ct.arch, ct.head_dim, ct.q_dim, ct.kv_dim) == ("llama", 256, 3072, 1024)
    assert ct.num_heads // ct.num_kv_heads == 3
    smoke = ModelConfig(**chip_smoke.FALCON3_7B)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(
        ct.replace(norm_topk_prob=smoke.norm_topk_prob))


def test_bf16_checkpoint_loads_its_own_bits(tmp_path):
    """A checkpoint stored in bf16, as published checkpoints are, loads to
    the stored bits, transposed, and to qtpu's; its .bin twin loads through
    qtpu's .float() path to the same bits in both packages."""
    model, _ = _hf_model("llama")
    model = model.to(torch.bfloat16)
    sd = model.state_dict()
    model.save_pretrained(tmp_path / "st", safe_serialization=True)
    model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    cfg = thf.config_from_hf(str(tmp_path / "st"))
    p = thf.load_llama_params(str(tmp_path / "st"), cfg, torch.bfloat16, device="cpu")
    assert torch.equal(p["embed"].view(torch.int16),
                       sd["model.embed_tokens.weight"].view(torch.int16))
    for i in range(L):
        want = sd[f"model.layers.{i}.self_attn.k_proj.weight"].T
        assert torch.equal(p["layers"]["k_proj"]["w"][i].view(torch.int16),
                           want.contiguous().view(torch.int16))
    pb = thf.load_llama_params(str(tmp_path / "bin"), cfg, torch.bfloat16, device="cpu")
    jcfg = jhf.config_from_hf(str(tmp_path / "bin"))
    lt, lb = _leaves(p), _leaves(pb)
    for fmt in ("st", "bin"):
        lj = _leaves(jhf.load_llama_params(str(tmp_path / fmt), jcfg))
        for k in lt:
            np.testing.assert_array_equal(_bits(to_numpy(lt[k])), _bits(np.asarray(lj[k])),
                                          err_msg=k)
            np.testing.assert_array_equal(_bits(to_numpy(lb[k])), _bits(np.asarray(lj[k])),
                                          err_msg=k)


# every dtype the reader takes, with values that use the whole range
READER_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int64,
                 torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool]


def _all_dtypes(seed):
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(READER_DTYPES):
        shape = (3, 5) if i % 2 else (7,)
        if dt.is_floating_point:
            out[f"t.{i}"] = (torch.randn(shape, generator=gen, dtype=torch.float64) * 1e3).to(dt)
        elif dt == torch.bool:
            out[f"t.{i}"] = torch.randint(0, 2, shape, generator=gen).bool()
        else:
            info = torch.iinfo(dt)
            out[f"t.{i}"] = torch.randint(info.min, info.max, shape, generator=gen, dtype=dt)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros((0, 4), dtype=torch.int32)
    return out


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            w = to_torch(w, device="cpu").reshape(w.shape)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype.is_floating_point:  # bits, not values (NaN, -0.0)
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[g.dtype.itemsize]
            assert torch.equal(g.view(bits), w.view(bits)), k
        else:
            assert torch.equal(g, w), k


def test_reader_equals_safetensors_on_every_dtype(tmp_path):
    tensors = _all_dtypes(0)
    f = tmp_path / "one.safetensors"
    torch_save_file(tensors, str(f), metadata={"format": "pt"})
    got = safetensors_io.load_file(f)
    _same(got, torch_load_file(str(f)))
    # numpy's reader gives bf16 as ml_dtypes.bfloat16 (JAX registers it)
    _same(got, np_load_file(str(f)))


def test_reader_on_a_sharded_checkpoint(tmp_path):
    model, _ = _hf_model("llama")
    model.save_pretrained(tmp_path, safe_serialization=True, max_shard_size="100KB")
    index = json.loads((tmp_path / safetensors_io.INDEX).read_text())
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) > 2
    want = {}
    for s in shards:
        want.update(torch_load_file(str(tmp_path / s)))
    # a stray file the index does not name is not read
    torch_save_file({"stray": torch.zeros(2)}, str(tmp_path / "consolidated.safetensors"))
    got = safetensors_io.load_dir(tmp_path)
    _same(got, want)
    assert sorted(got) == sorted(index["weight_map"])
    # and the import of the sharded checkpoint equals qtpu's
    cfg = thf.config_from_hf(str(tmp_path))
    (tmp_path / "consolidated.safetensors").unlink()
    pt = _leaves(thf.load_llama_params(str(tmp_path), cfg, torch.float32, device="cpu"))
    pj = _leaves(jhf.load_llama_params(str(tmp_path), jhf.config_from_hf(str(tmp_path)),
                                       jnp.float32))
    for k in pt:
        np.testing.assert_array_equal(_bits(to_numpy(pt[k])), _bits(np.asarray(pj[k])))


def test_reader_refuses_what_it_does_not_take(tmp_path):
    f = tmp_path / "f8.safetensors"
    torch_save_file({"x": torch.zeros(4, dtype=torch.float8_e4m3fn)}, str(f))
    with pytest.raises(ValueError, match="F8_E4M3"):
        safetensors_io.load_file(f)
    bad = tmp_path / "bad.safetensors"
    header = json.dumps({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(len(header).to_bytes(8, "little") + header + bytes(16))
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(bad)
    with pytest.raises(FileNotFoundError):
        thf.load_checkpoint(str(tmp_path / "none"), ModelConfig(), device="cpu")


def test_the_port_imports_no_safetensors_or_ml_dtypes():
    """The modules of this slice import neither package the card lacks."""
    root = Path(thf.__file__).resolve().parents[1]
    for rel in ("models/hf_import.py", "models/safetensors_io.py", "ckpt/io.py",
                "data/pipeline.py"):
        tree = ast.parse((root / rel).read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not names & {"jax", "qtpu", "safetensors", "ml_dtypes"}, (rel, names)
