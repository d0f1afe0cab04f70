"""The Bent-Pyramid number system (the parts the decoder slice needs)."""
