"""Utilities: per-stage tracing."""
