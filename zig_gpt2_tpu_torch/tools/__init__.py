"""Measurement scripts for the card (each runs only where CUDA is)."""
