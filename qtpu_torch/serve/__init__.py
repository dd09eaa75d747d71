"""Serving stack of the port: int8/bf16 KV cache (kvcache), prefill and
decode steps with sampling (decode), the continuous-batching engine
(batching) and the demo CLI (`python -m qtpu_torch.serve`)."""
