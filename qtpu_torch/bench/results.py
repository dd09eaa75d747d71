"""Benchmark result container (port of qtpu/bench/results.py, reference
benchmark_runner.py:46-84). `to_dict` gives the reference results-JSON
schema field for field, with qtpu's optional extensions (packed size and
perplexity, serving tokens/s) only when set."""

from __future__ import annotations

from typing import Optional


class BenchmarkResult:
    def __init__(self, method_name: str, config: dict):
        self.method_name = method_name
        self.config = config
        self.perplexity: Optional[float] = None
        self.model_size_bits: Optional[float] = None
        self.model_size_mb: Optional[float] = None
        self.bits_per_byte: Optional[float] = None
        self.runtime_seconds: Optional[float] = None
        self.error: Optional[str] = None
        self.packed_size_bits: Optional[int] = None
        self.tokens_per_second: Optional[float] = None
        # perplexity of the really-packed artifact next to the fake-quant one
        self.packed_perplexity: Optional[float] = None
        self.packed_error: Optional[str] = None

    def is_success(self) -> bool:
        return self.error is None and (
            self.perplexity is not None or self.tokens_per_second is not None
        )

    def to_dict(self) -> dict:
        d = {
            "method": self.method_name,
            "perplexity": self.perplexity,
            "model_size_mb": self.model_size_mb,
            "model_size_bits": self.model_size_bits,
            "bits_per_byte": self.bits_per_byte,
            "runtime_seconds": self.runtime_seconds,
            "error": self.error,
            "config": self.config,
        }
        for key in ("packed_size_bits", "tokens_per_second", "packed_perplexity", "packed_error"):
            if getattr(self, key) is not None:
                d[key] = getattr(self, key)
        return d

    def __str__(self) -> str:
        if not self.is_success():
            return f"{self.method_name:<12} | ERROR: {self.error}"
        if self.perplexity is None and self.tokens_per_second is not None:
            return (
                f"{self.method_name:<12} | "
                f"{self.tokens_per_second:8.1f} tokens/s | "
                f"Time: {self.runtime_seconds or 0:.2f}s"
            )
        bits = f"{self.bits_per_byte:.2f}" if self.bits_per_byte is not None else "N/A"
        return (
            f"{self.method_name:<12} | "
            f"PPL: {self.perplexity:8.2f} | "
            f"Size: {self.model_size_mb:8.2f} MB | "
            f"Bits/Byte: {bits} | "
            f"Time: {self.runtime_seconds or 0:.2f}s"
        )
