"""Benchmark CLI (port of `python -m qtpu.bench`, the reference's
`python benchmark_runner.py <config.json>`).

Usage: python -m qtpu_torch.bench [config.json] [--out results.json] [--device cuda|cpu]
       torchrun --nproc-per-node N -m qtpu_torch.bench cfg.json

--device overrides the config's "device" (default cuda). Under torchrun
the processes join one world first (qtpu_torch.sharding.multihost: NCCL
when each rank has a card of its own, its local rank's; gloo on the CPU or
on a shared card) and the config's "mesh" spans it; one process runs as
before.
"""

import sys

from qtpu_torch.bench.runner import QuantizationBenchmark
from qtpu_torch.sharding.multihost import device_of_rank, initialize_multihost


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--out", "--device"):
        if flag in args:
            i = args.index(flag)
            opts[flag] = args[i + 1]
            del args[i:i + 2]
    config_path = args[0] if args else "config.json"
    info = initialize_multihost(device=opts.get("--device"))
    device = opts.get("--device")
    if info["process_count"] > 1 and device != "cpu":
        device = str(device_of_rank())
    print(f"Loading configuration from: {config_path}")
    bench = QuantizationBenchmark(config_path, device=device)
    bench.run_all_benchmarks()
    bench.save_results(opts.get("--out") or bench.config.get("output_path", "benchmark_results.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
