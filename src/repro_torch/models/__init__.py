"""The LM substrate's models, the dense decoder-only subset."""
