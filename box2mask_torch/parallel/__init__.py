"""Training across processes: data parallel (mesh.py)."""
