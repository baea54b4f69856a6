"""Verification aids and image-quality metrics."""
