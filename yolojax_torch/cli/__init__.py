"""CLI entry points of the port (``python -m yolojax_torch.cli.detect``).

Argument parsing and logging setup are ``yolojax.cli``'s, reused unchanged.
"""
