"""Fingerprint operators: plain PyTorch stages and kernel wrappers."""
