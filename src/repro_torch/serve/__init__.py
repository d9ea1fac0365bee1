"""Serving statistics (``metrics``); the solver-serving layer comes
with ROADMAP.md queue 1 item 6."""
