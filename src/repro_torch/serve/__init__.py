"""Serving substrate: ``engine`` serves LM decode (continuous batching over
a fixed-slot KV cache)."""
