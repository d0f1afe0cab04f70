"""AdamW with a warmup-cosine schedule, and the int8 error-feedback codec."""
