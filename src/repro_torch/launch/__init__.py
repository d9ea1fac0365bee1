"""Prefill and decode step factories and the serving driver."""
