"""Sorted fingerprint index: host store, device search, song catalog."""
