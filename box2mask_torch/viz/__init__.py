"""Visualizations of the port (its copy of box2mask_tpu/viz)."""
