"""Utilities of the port: checkpoint loading."""
