"""Data pipeline (numpy only)."""
