"""Benchmark CLI (port of `python -m qtpu.bench`, the reference's
`python benchmark_runner.py <config.json>`).

Usage: python -m qtpu_torch.bench [config.json] [--out results.json] [--device cuda|cpu]

--device overrides the config's "device" (default cuda).
"""

import sys

from qtpu_torch.bench.runner import QuantizationBenchmark


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--out", "--device"):
        if flag in args:
            i = args.index(flag)
            opts[flag] = args[i + 1]
            del args[i:i + 2]
    config_path = args[0] if args else "config.json"
    print(f"Loading configuration from: {config_path}")
    bench = QuantizationBenchmark(config_path, device=opts.get("--device"))
    bench.run_all_benchmarks()
    bench.save_results(opts.get("--out") or bench.config.get("output_path", "benchmark_results.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
