"""Paged serving: block-pool KV cache, priority scheduler, greedy
sampling, and the engine that interleaves chunked prefill with decode."""
