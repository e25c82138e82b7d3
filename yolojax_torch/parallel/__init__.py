"""The train step of the port (one device; see ``mesh.py``)."""
