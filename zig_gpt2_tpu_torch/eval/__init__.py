"""Evaluation: token-level perplexity and the quantization gate."""
