"""Config-driven benchmark orchestrator (port of qtpu/bench/runner.py,
reference benchmark_runner.py:91-743) for the methods raw, rtn, awq, gptq,
pot, apot and smoothquant.

The phases are qtpu's: setup -> raw baseline -> per method (and per w_bit
of a sweep) calibrate if the method needs it, quantize + eval with
per-method error isolation -> the packed-vs-fake audit (`packed_eval`: the
really-packed artifact through K1/K5, K6 for SmoothQuant W8A8 and K7 for
POT/APOT codebooks) -> the optional serving pseudo-method (int8 or bf16 KV
cache) -> the summary table with improvements vs
raw -> the reference-schema results JSON. Weights are random from the
config's seed (torch.Generator, so not qtpu's numbers). Calibration
statistics are collected once and reused; GPTQ with error compensation
collects them again with the true Hessians when the first collection had
none (qtpu's rule).

With "checkpoint_path" the model is a local Hugging Face checkpoint
(params, tokenizer and model config from its directory, on the run's
device); with "save_artifacts" = {"dir", "method"} the run ends by saving
that method's packed artifact (qtpu_torch.ckpt), a failed save logged and
the run carried on, as in qtpu.

Every method runs on the llama family, GPT-2, OPT and the sparse-MoE
family (a preset's or a checkpoint's: Mixtral, Qwen2-MoE), the MoE expert
sites calibrated over the tokens routed to each expert. With "profile_dir"
every perplexity eval runs inside a torch.profiler session
(qtpu_torch.utils.timing.profile_trace) that writes its Chrome trace into
that directory, as qtpu's jax.profiler trace.

"mesh" = {"data", "model", "pipe"} (qtpu's `_setup_mesh`) builds a mesh
from the initialized torch.distributed world: ('data', 'model') or, with
pipe > 1, ('data', 'pipe'[, 'model']). Every rank holds the whole params
(the same seed, the same quantization); calibration shards its rows over
`data` (qtpu_torch.calib.sharded), every perplexity eval shards its blocks
over `data` and its params over `model` (or runs the GPipe schedule over
`pipe`), and the serving run gives each data rank its rows of the batch
on its tensor-parallel shards. With fewer ranks than the mesh asks, or
layers that do not split over pipe, qtpu's message is logged and the run
goes on single-device (qtpu's own rule). Only the primary rank writes the
results and the artifact.

CLI:  python -m qtpu_torch.bench <config.json> [--out results.json] [--device cpu]
      torchrun --nproc-per-node N -m qtpu_torch.bench <config.json>
"""

from __future__ import annotations

import contextlib
import json
import time
import traceback
from datetime import datetime

import numpy as np
import torch

from qtpu_torch.bench.results import BenchmarkResult
from qtpu_torch.calib import collect_calibration_stats
from qtpu_torch.ckpt import save_quantized
from qtpu_torch.configs import load_config, validate_config
from qtpu_torch.core.dtypes import MiB, resolve_dtype
from qtpu_torch.core.sizing import count_params, get_model_size
from qtpu_torch.data import get_calibration_dataset, get_test_dataset
from qtpu_torch.eval import evaluate_perplexity
from qtpu_torch.models import get_arch, get_model_config
from qtpu_torch.models.hf_import import config_from_hf, load_checkpoint
from qtpu_torch.quant.apply import (
    CALIBRATED_METHODS,
    fold_smooth,
    fuse_packed_sites,
    pack_model,
    quantize_model,
)
from qtpu_torch.sharding.multihost import is_primary

METHODS = ("awq", "gptq", "pot", "apot", "smoothquant", "rtn")
# benchmark_serving: one warm run of prefill + SERVE_WARM_STEPS decode
# steps, then the timed run of prefill + SERVE_STEPS steps
SERVE_WARM_STEPS = 2
SERVE_STEPS = 32


class QuantizationBenchmark:
    def __init__(self, config, verbose: bool | None = None, device=None):
        if isinstance(config, (str, bytes)) or hasattr(config, "__fspath__"):
            config = load_config(config)
        self.config = validate_config(config)
        if device is not None:
            self.config["device"] = str(device)
        self.device = torch.device(self.config["device"])
        self.verbose = self.config.get("verbose", True) if verbose is None else verbose
        self.verbose = self.verbose and is_primary()  # one rank prints
        self.model_cfg = None
        self.params = None
        self.tokenizer = None
        self.calib_samples = None
        self.stats = None
        self.test_dataset = None
        self.mesh = None
        self.results: dict[str, BenchmarkResult] = {}

    def log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- setup
    def setup(self):
        cfg = self.config
        ckpt = cfg.get("checkpoint_path")
        # a local HF checkpoint's model config (and arch) is its own,
        # whatever the run's model_name
        self.model_cfg = config_from_hf(ckpt) if ckpt else get_model_config(cfg["model_name"])
        self.log(f"Setting up benchmark for {cfg['model_name']} on {self.device}...")
        dtype = resolve_dtype(cfg.get("dtype", "bfloat16"))
        self.arch = get_arch(self.model_cfg.arch)
        if ckpt:
            self.params, self.tokenizer = load_checkpoint(ckpt, self.model_cfg, dtype,
                                                          device=self.device)
        else:
            self.params = self.arch.init_params(
                self.model_cfg, seed=cfg.get("seed", 0), device=self.device, dtype=dtype
            )
            self.tokenizer = None
        self.test_dataset = get_test_dataset(
            self.tokenizer,
            cfg["test_dataset"],
            cfg.get("test_dataset_config"),
            cfg.get("test_split", "test"),
            n_samples=cfg.get("n_test_samples", 40),
            block_size=cfg.get("test_block_size", 2048),
            vocab_size=self.model_cfg.vocab_size,
        )
        self.calib_samples = get_calibration_dataset(
            self.tokenizer,
            cfg["calibration_dataset"],
            cfg.get("calibration_dataset_config"),
            cfg.get("calibration_split", "validation"),
            n_samples=cfg.get("n_calibration_samples", 256),
            block_size=cfg.get("calibration_block_size", 512),
            vocab_size=self.model_cfg.vocab_size,
        )
        self._setup_mesh()
        self.log("Setup complete!")

    def _setup_mesh(self):
        """qtpu's `_setup_mesh`: the mesh of config["mesh"] over the
        initialized world, when it asks for more than one rank and the
        world has them."""
        from qtpu_torch.sharding.mesh import make_mesh, world_size
        from qtpu_torch.sharding.pipeline import make_pipe_mesh

        self.mesh = None
        mcfg = self.config.get("mesh") or {}
        dp, tp = int(mcfg.get("data", 1)), int(mcfg.get("model", 1))
        pp = int(mcfg.get("pipe", 1))
        n_dev = world_size()
        if dp == -1:
            dp = max(1, n_dev // max(tp * pp, 1))
        if dp * tp * pp <= 1:
            return
        if dp * tp * pp > n_dev:
            self.log(f"mesh {dp}x{tp}x{pp} needs {dp * tp * pp} devices, have "
                     f"{n_dev} — running single-device")
            return
        if pp > 1:
            if self.model_cfg.num_layers % pp:
                self.log(f"mesh: {self.model_cfg.num_layers} layers do not split over "
                         f"pipe={pp} — running single-device")
                return
            self.mesh = make_pipe_mesh(pp, data=dp, model=tp)
            self.log(f"mesh: data={dp} x pipe={pp} x model={tp}")
            return
        self.mesh = make_mesh(data=dp, model=tp)
        self.log(f"mesh: data={dp} x model={tp}")

    def _prepare_activations(self, need_hessian: bool):
        """Calibration statistics over the calibration blocks, collected
        once; again with the true Hessians when they are needed and the
        first collection had none."""
        if self.stats is not None and (not need_hessian or self.stats.hessian is not None):
            return
        self.log("\nCollecting activation statistics...")
        self.stats = None  # free the old statistics before the new ones
        if self.mesh is not None:
            from qtpu_torch.calib.sharded import collect_calibration_stats_sharded

            self.stats = collect_calibration_stats_sharded(
                self.arch.forward, self.params, self.calib_samples, self.model_cfg, self.mesh,
                collect_hessian=need_hessian,
            )
            return
        self.stats = collect_calibration_stats(
            self.arch.forward, self.params, self.calib_samples, self.model_cfg,
            collect_hessian=need_hessian, verbose=self.verbose,
        )

    # ------------------------------------------------------------ metrics
    def _original_size_bytes(self) -> int:
        itemsize = resolve_dtype(self.config.get("dtype", "bfloat16")).itemsize
        return count_params(self.params) * itemsize

    def _fill_size(self, result, data_width, group_size, use_zero_point):
        size_bits = get_model_size(self.params, data_width=data_width, group_size=group_size,
                                   use_zero_point=use_zero_point)
        result.model_size_bits = size_bits
        result.model_size_mb = size_bits / (8 * MiB)
        orig = self._original_size_bytes()
        result.bits_per_byte = size_bits / orig if orig > 0 else None

    def _eval(self, params, qmeta=None) -> float:
        profile_dir = self.config.get("profile_dir")
        ctx = contextlib.nullcontext()
        if profile_dir:
            from qtpu_torch.utils.timing import profile_trace

            ctx = profile_trace(profile_dir)  # a Chrome trace of the eval
        with ctx:
            return evaluate_perplexity(
                params,
                self.test_dataset,
                self.model_cfg,
                n_samples=self.config.get("n_test_samples", 40),
                block_size=self.config.get("test_block_size", 2048),
                qmeta=qmeta,
                arch=self.model_cfg.arch,
                mesh=self.mesh,
                verbose=self.verbose,
            )

    # ------------------------------------------------------- method runs
    def benchmark_raw_model(self):
        self.log("\n" + "=" * 80 + "\nEVALUATING RAW MODEL\n" + "=" * 80)
        result = BenchmarkResult("raw", {})
        try:
            start = time.time()
            result.perplexity = self._eval(self.params)
            self._fill_size(result, data_width=32, group_size=-1, use_zero_point=True)
            result.runtime_seconds = time.time() - start
            self.log(f"✓ {result}")
        except Exception as e:  # error isolation, reference :243-245
            result.error = str(e)
            traceback.print_exc()
            self.log(f"✗ Raw Model - Error: {e}")
        self.results["raw"] = result
        return result

    def benchmark_method(self, method: str):
        if method not in self.config["quantization_methods"]:
            return None
        mcfg = self.config["quantization_config"][method]
        if isinstance(mcfg.get("w_bit"), (list, tuple)):
            # bit-width sweep: one run per width, recorded as method@wN
            return [
                self._benchmark_one(method, dict(mcfg, w_bit=int(wb)), name=f"{method}@w{wb}")
                for wb in mcfg["w_bit"]
            ]
        return self._benchmark_one(method, mcfg, name=method)

    def _benchmark_one(self, method: str, mcfg: dict, name: str):
        self.log("\n" + "=" * 80 + f"\nBENCHMARKING {name.upper()}\n" + "=" * 80)
        result = BenchmarkResult(name, mcfg)
        try:
            start = time.time()
            stats = None
            if method in CALIBRATED_METHODS:
                need_h = (method == "gptq" and mcfg.get("error_compensation", False)
                          and mcfg.get("true_hessian", True))
                self._prepare_activations(need_hessian=need_h)
                stats = self.stats
            qparams = quantize_model(self.params, method, mcfg, stats, arch=self.model_cfg.arch)
            self._sync()
            self.log(f"  quantization took {time.time() - start:.2f}s")
            result.perplexity = self._eval(qparams)
            del qparams
            self._fill_size(result, data_width=mcfg["w_bit"],
                            group_size=mcfg.get("q_group_size", -1),
                            use_zero_point=method not in ("pot", "apot"))
            result.runtime_seconds = time.time() - start
            if self.config.get("packed_eval", False):
                self._packed_eval(result, method, mcfg, stats)
            self.log(f"✓ {result}")
        except Exception as e:
            result.error = str(e)
            traceback.print_exc()
            self.log(f"✗ {name} - Error: {e}")
        self.results[name] = result
        return result

    def _packed(self, method: str, mcfg: dict, stats=None):
        """The serving artifact of a method: pack, fold smooth vectors,
        fuse the sites that share an input."""
        arch = self.model_cfg.arch
        packed, qmeta = pack_model(self.params, method, mcfg, stats, arch=arch)
        packed, qmeta = fold_smooth(packed, qmeta, arch=arch)
        return fuse_packed_sites(packed, qmeta, arch=arch)

    def _packed_eval(self, result, method, mcfg, stats=None):
        """Packed-vs-fake audit ("packed_eval": true): the perplexity of the
        really-packed artifact of the same method, through the serving
        path's kernels, recorded as packed_perplexity."""
        try:
            packed, qmeta = self._packed(method, mcfg, stats)
            result.packed_perplexity = self._eval(packed, qmeta=qmeta)
            self.log(f"  packed-vs-fake ppl: {result.packed_perplexity:.4f}"
                     f" vs {result.perplexity:.4f}")
        except Exception as e:  # a packed-path failure must not kill the run
            result.packed_error = str(e)
            traceback.print_exc()
            self.log(f"  packed eval failed: {e}")

    def benchmark_serving(self, method: str | None = None):
        """Decode throughput through the packed serving path (prefill, then
        greedy decode steps on the int8 or bf16 KV cache, kv_cache_dtype),
        recorded as the 'serving'
        pseudo-method's tokens_per_second: batch / the mean time of one
        decode step over SERVE_STEPS steps after a prefill, timed on the
        host around device synchronizations, after one warm run. Enabled by
        config["serving"]["benchmark"] = true. Under a ('data', 'model')
        mesh each data rank decodes its rows of the batch on its
        tensor-parallel shards (eager steps), and the rate is the batch's."""
        from qtpu_torch.serve.decode import decode_step, prefill
        from qtpu_torch.serve.kvcache import init_cache
        from qtpu_torch.sharding.mesh import axis_rank, axis_size, local_group
        from qtpu_torch.sharding.specs import shard_model

        scfg = self.config.get("serving", {})
        method = method or scfg.get("pack_method", "rtn")
        mcfg = self.config["quantization_config"].get(method, {"w_bit": 4, "q_group_size": 128})
        result = BenchmarkResult("serving", {"pack_method": method, **mcfg})
        try:
            start = time.time()
            needs_stats = method in ("awq", "smoothquant")  # qtpu's rule: gptq gets none
            if needs_stats:
                self._prepare_activations(need_hessian=False)
            packed, qmeta = self._packed(method, mcfg, self.stats if needs_stats else None)
            cfg, arch = self.model_cfg, self.model_cfg.arch
            B = int(scfg.get("max_batch_size", 8))
            P = min(128, cfg.max_seq_len // 2)
            quant_kv = scfg.get("kv_cache_dtype", "int8") == "int8"
            prompt = torch.from_numpy(
                np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
            ).to(self.device)
            mesh = self.mesh if self.mesh is not None and "pipe" not in self.mesh.mesh_dim_names \
                else None
            tp = local_group(mesh, "model")
            if mesh is not None:  # this data rank's rows, this model rank's shards
                dp, d = axis_size(mesh, "data"), axis_rank(mesh, "data")
                if B % dp:
                    raise ValueError(f"serving batch {B} does not split over data={dp}")
                prompt = prompt[d * (B // dp):(d + 1) * (B // dp)]
                packed, qmeta, cfg = shard_model(packed, qmeta, cfg, mesh)
            Bl = prompt.shape[0]

            def run(n_steps):
                cache = init_cache(cfg, Bl, P + 64, quantized=quant_kv, device=self.device)
                logits, cache = prefill(packed, prompt, cache, cfg, qmeta, arch=arch, tp=tp)
                tok = torch.argmax(logits, -1).to(torch.int32)
                pos = torch.full((Bl,), P, dtype=torch.int32, device=self.device)
                self._sync()
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    logits, cache = decode_step(packed, tok, pos, cache, cfg, qmeta, arch=arch,
                                                tp=tp)
                    tok = torch.argmax(logits, -1).to(torch.int32)
                    pos = pos + 1
                self._sync()
                return time.perf_counter() - t0

            with torch.inference_mode():
                run(SERVE_WARM_STEPS)
                per_tok = max(run(SERVE_STEPS) / SERVE_STEPS, 1e-9)
            result.runtime_seconds = time.time() - start
            result.tokens_per_second = B / per_tok
            self.log(f"✓ serving[{method}]: {B / per_tok:.1f} tokens/s "
                     f"(batch {B}, {'int8' if quant_kv else 'bf16'} KV, {self.device})")
        except Exception as e:
            result.error = str(e)
            traceback.print_exc()
            self.log(f"✗ serving - Error: {e}")
        self.results["serving"] = result
        return result

    def run_all_benchmarks(self):
        self.setup()
        self.benchmark_raw_model()
        for method in METHODS:
            self.benchmark_method(method)
        if self.config.get("serving", {}).get("benchmark", False):
            self.benchmark_serving()
        art = self.config.get("save_artifacts")
        if art and is_primary():
            try:
                self.save_artifacts(art["dir"], art.get("method", "rtn"))
            except Exception as e:  # qtpu's rule: a failed save is logged, the run goes on
                traceback.print_exc()
                self.log(f"✗ artifact save failed: {e}")
        self.print_summary()

    def save_artifacts(self, out_dir: str, method: str):
        """Save the packed artifact of one method (qtpu_torch.ckpt, qtpu's
        format), so calibration decouples from serving. Configured by
        config["save_artifacts"] = {"dir": ..., "method": ...}. The sites
        are saved as pack_model gives them (unfused), as qtpu saves them."""
        mcfg = self.config["quantization_config"][method]
        needs_stats = method in ("awq", "smoothquant", "gptq")
        if needs_stats:
            self._prepare_activations(need_hessian=False)
        packed, qmeta = pack_model(self.params, method, mcfg,
                                   self.stats if needs_stats else None, arch=self.model_cfg.arch)
        save_quantized(out_dir, packed, qmeta,
                       {"method": method, "model": self.config["model_name"], **mcfg})
        self.log(f"Packed {method} artifact saved to {out_dir}")

    # ---------------------------------------------------------- reporting
    def print_summary(self):
        self.log("\n" + "=" * 80 + "\nBENCHMARK SUMMARY\n" + "=" * 80)
        self.log(f"\nModel: {self.config['model_name']}")
        self.log(f"Calibration: {self.config['calibration_dataset']}")
        self.log(f"Test Dataset: {self.config['test_dataset']}")
        self.log(f"Timestamp: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}")
        self.log("-" * 100)
        for result in self.results.values():
            self.log(str(result))
        self.log("-" * 100)
        raw = self.results.get("raw")
        if raw and raw.is_success():
            self.log("\nImprovements vs Raw Model:")
            for name, result in self.results.items():
                if name != "raw" and result.is_success() and result.perplexity is not None:
                    ppl_deg = (result.perplexity / raw.perplexity - 1) * 100
                    size_red = (1 - result.model_size_mb / raw.model_size_mb) * 100
                    self.log(f"  {name:10s}: PPL {ppl_deg:+6.2f}% | Size -{size_red:6.2f}%")
        self.log("=" * 100 + "\n")

    def environment(self) -> dict:
        cuda = self.device.type == "cuda"
        devices = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                   if cuda else ["cpu"])
        return {
            "backend": self.device.type,
            "devices": devices,
            "device_name": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
        }

    def save_results(self, output_path: str = "benchmark_results.json"):
        """The results JSON; on the primary rank only."""
        if not is_primary():
            return
        results_dict = {
            "timestamp": datetime.now().isoformat(),
            "config": self.config,
            "environment": self.environment(),
            "results": {k: v.to_dict() for k, v in self.results.items()},
        }
        with open(output_path, "w") as f:
            json.dump(results_dict, f, indent=2)
        self.log(f"\nResults saved to {output_path}")
