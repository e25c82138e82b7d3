"""Utilities of the port: checkpoints, the optimizers and schedules, the
train-loop summaries and drawing."""
