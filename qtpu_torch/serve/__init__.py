"""Serving stack of the port: int8/bf16 KV cache (kvcache), prefill and
decode steps with sampling (decode), the continuous-batching engine
(batching) with its decode blocks as CUDA graphs (graphs), the HTTP front
end (http) and the demo CLI (`python -m qtpu_torch.serve`)."""
