"""Serving: the lock-step engine (``engine.py``), the paged engine
(block-pool KV cache, priority scheduler, chunked prefill interleaved with
decode), their entry points as CUDA graphs (``graphs.py``), counter-based
sampling bit for bit the reference's (``sampling.py``), and the
synthetic-traffic harness (``traffic.py``)."""
