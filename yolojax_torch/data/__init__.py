"""Data path of the port: the deterministic eval/detect resize."""
