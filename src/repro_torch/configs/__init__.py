"""Architecture + shape configurations (one module per assigned arch)."""
