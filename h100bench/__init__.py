"""The benchmark of box2mask_torch on NVIDIA H100 cards (BENCHMARK.json)."""
