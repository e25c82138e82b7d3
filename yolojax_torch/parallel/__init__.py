"""The train step of the port (``mesh.py``) and the collectives it and eval
use across ranks (``collectives.py``)."""
