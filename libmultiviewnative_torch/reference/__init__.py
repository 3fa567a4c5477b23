"""Acceptance-test error norms (numpy only)."""
