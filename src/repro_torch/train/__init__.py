"""The train step (gradient accumulation + AdamW) and the trainer loop."""
