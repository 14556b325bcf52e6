"""Device kernels and their plain PyTorch versions: dense ray-triangle
closest hit and the emissive light probe, plus the traversal dispatch."""
